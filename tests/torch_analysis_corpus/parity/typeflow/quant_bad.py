# corpus-rules: dtypeflow
"""Twin of the reference corpus's typeflow/quant_bad.py in the port's
idioms (line for line): an unregistered int8w code cast on the traced
surface (001) and a decision-path vocab product on a registered
relaxed-serving path with no f32 accumulation (003; the test injects
the ``low_precision=True`` entry for ``registered_quant_path``).  The
negative case is the idiom ``ops/rowgemm.py`` ships: registered casts,
the f32-accumulating pinned product, the per-channel scale after it.
Both functions are torch.compile roots.
"""

import torch
from cst_captioning_torch.ops.rnn import dot_f32


@torch.compile
def unregistered_quant_cast(q, scale):
    # int8 codes dequantized inline with no CAST_REGISTRY entry saying
    # which parity tier survives the quantization rounding
    return q.to(torch.bfloat16) * scale  # expect: CST-DTY-001


@torch.compile
def registered_quant_path(h, q, scale):
    # the cast sites are registered (relaxed-serving entry injected by
    # the test) ...
    hc = h.to(torch.bfloat16)
    # ... but the DECISION product — vocab logits feeding the top-K —
    # must still accumulate in f32: applying the scale after a bf16
    # reduction does not un-round it
    bad = torch.matmul(hc, q.to(torch.bfloat16)) * scale  # expect: CST-DTY-003
    # negative: the pinned f32-accumulating product, scale applied
    # after, so decisions consume f32
    good = dot_f32(
        hc, q.to(torch.bfloat16), torch.bfloat16
    ) * scale
    return bad + good
