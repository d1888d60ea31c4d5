"""XE/WXE training of the port: train steps with the optax-equivalent
optimizer (``steps``), checkpoints (``checkpoint``), SIGTERM handling
(``preemption``) and the epoch loop (``trainer``).  CST is not ported
yet (ROADMAP.md Queue 1, item 2)."""
