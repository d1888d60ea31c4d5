# corpus-rules: dtypeflow
"""Twin of the reference corpus's typeflow/quant_kernel_bad.py in the
port's idioms (line for line).  The fused decode kernels stream int8
vocab / gate code tiles and dequantize in-kernel: the per-channel scale
applied AFTER an f32 accumulation (``ops/rowgemm.py::row_dot``
semantics).  Two ways that contract decays: an unregistered code-tile
cast on the traced surface (001 — no CAST_REGISTRY entry claiming the
relaxed-serving tier for the quantization rounding) and a registered
in-kernel dequant whose product loses the f32 accumulation (003 —
scaling a bf16 reduction does not un-round it; the test injects the
``low_precision=True`` entry for ``registered_kernel_dequant``).  The
negative case is the plain versions' idiom: registered casts, the
pinned f32 product, per-logit scale after it, f32 bias."""

import torch
from cst_captioning_torch.ops.rnn import dot_f32


@torch.compile
def unregistered_kernel_dequant(h, q_tile, scale_tile):
    # a streamed int8 code tile cast to the activation dtype with no
    # CAST_REGISTRY entry naming the parity tier that survives the
    # quantization rounding
    w = q_tile.to(torch.bfloat16)  # expect: CST-DTY-001
    return dot_f32(
        h, w, torch.bfloat16
    ) * scale_tile


@torch.compile
def registered_kernel_dequant(h, q_tile, scale_tile, bias_tile):
    # the cast sites are registered (relaxed-serving entry injected by
    # the corpus test) ...
    hc = h.to(torch.bfloat16)
    wc = q_tile.to(torch.bfloat16)
    # ... but the post-accumulation scale multiply only preserves
    # row_dot's semantics over an f32 accumulator — scaling a bf16
    # reduction does not un-round it
    bad = torch.matmul(hc, wc) * scale_tile  # expect: CST-DTY-003
    # negative: the plain versions' idiom — codes cast losslessly to
    # the activation dtype, f32 accumulation pinned, per-logit scale
    # applied after the accumulation, f32 bias
    good = dot_f32(
        hc, wc, torch.bfloat16
    ) * scale_tile + bias_tile
    return bad + good
