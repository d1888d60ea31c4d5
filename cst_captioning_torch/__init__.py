"""cst_captioning_torch — the PyTorch/CUDA port of the captioning system.

The JAX package in the same repository is the reference; this package
mirrors its layout and module names, and runs on an NVIDIA H100.  Every kernel the reference wrote in Pallas for the TPU
becomes a hand-written CUDA kernel here (``csrc/``), built with ``nvcc``
for ``sm_90a`` at first use and bound through ``ctypes``
(``ops/_build.py``).  Each kernel wrapper keeps its plain PyTorch
version beside it; the wrapper takes the plain version only for tensors
on the CPU (the tests) and launches the kernel for CUDA tensors.

Ported so far: the batch-at-a-time serving path (``serving.continuous =
false``) at meanpool widths, beam and greedy, through the ``lstm_beam``
and ``lstm_sample`` kernels; and XE/WXE training (``training/``,
``cli/train.py``) through the ``lstm_recurrence`` kernel.  ROADMAP.md
lists what is still to come.

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
