"""cst_captioning_torch — the PyTorch/CUDA port of the captioning system.

The JAX package in the same repository is the reference; this package
mirrors its layout and module names, and runs on an NVIDIA H100.  Every kernel the reference wrote in Pallas for the TPU
becomes a hand-written CUDA kernel here (``csrc/``), built with ``nvcc``
for ``sm_90a`` at first use and bound through ``ctypes``
(``ops/_build.py``).  Each kernel wrapper keeps its plain PyTorch
version beside it; the wrapper takes the plain version only for tensors
on the CPU (the tests) and launches the kernel for CUDA tensors.

Ported so far: serving, beam and greedy, through the continuous slot
loop (the ``fused_context_attention`` and ``row_gemm`` kernels) or the
batch-at-a-time ladder (``serving.continuous = false``: the
``lstm_beam`` and ``lstm_sample`` kernels, or ``attlstm_beam`` and
``attlstm_sample`` under attention fusion); and XE/WXE training
(``training/``, ``cli/train.py``) through the ``lstm_recurrence``
kernel (meanpool) or the ``attlstm_recurrence`` forward and backward
kernels (attention), with scheduled sampling through the per-step loop
(under attention the ``fused_context_attention`` forward and backward
kernels); CST training on the ``lstm_sample`` rollout; and the beam-5
eval (``evaluation.evaluate_dataset``, ``cli/test.py``) and the staged
pipeline (``cli/pipeline.py``) on the ``lstm_beam`` kernel, reading the
reference's label h5 with per-video feature h5s or packed feature
directories (``data/``).  The production serving preset runs its own
scheduler, the multi-replica ``ReplicaSet`` with double-buffered slot
ticks, priorities, shedding, hedging and a requeue budget, traced by
the span tracer and flight recorder of ``observability/`` (the server's
``/debug`` endpoints, training's ``train.trace_file``).  Training and
serving run on (data x model) meshes of cards (``parallel/``: the 2D
update step, tensor-parallel serving with the cross-shard top-K merge,
frame-sharded attention, multi-process data loading).  ROADMAP.md lists
what is still to come.

The package imports ``torch`` and never ``jax``; the framework-free
modules it needs (config, constants, the data modules, the metric
suite) are its own copies.
"""

__version__ = "0.1.0"

from cst_captioning_torch.config import (  # noqa: F401
    PRESETS,
    Config,
    DataConfig,
    EvalConfig,
    ModelConfig,
    ServingConfig,
    TrainConfig,
    get_preset,
    parse_cli,
)
