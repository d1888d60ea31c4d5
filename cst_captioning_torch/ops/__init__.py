"""Tensor ops of the port: LSTM cell math (``rnn``), the kernel
wrappers with their plain versions (``beam``, ``sampler`` for decoding,
``lstm`` for the teacher-forced recurrence and its backward), the
decode kernels' shared helpers (``decode_common``), the training
criteria (``losses``) and the CUDA build (``_build``).  Nothing here
builds or loads a kernel at import time."""
