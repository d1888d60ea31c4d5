"""Tensor ops of the port: LSTM cell math (``rnn``), the fused decode
kernels' wrappers with their plain versions (``beam``, ``sampler``),
their shared helpers (``decode_common``) and the CUDA build
(``_build``).  Nothing here builds or loads a kernel at import time."""
