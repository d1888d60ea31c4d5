"""Training of the port: XE/WXE train steps with the optax-equivalent
optimizer (``steps``), the CST step and its CIDEr-D rewards (``cst``,
``rewards``), checkpoints (``checkpoint``), SIGTERM handling
(``preemption``) and the epoch loop (``trainer``)."""
