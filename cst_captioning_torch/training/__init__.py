"""Training of the port: XE/WXE train steps with the optax-equivalent
optimizer (``steps``), the CST step and its CIDEr-D rewards (``cst``,
``rewards``), checkpoints (``checkpoint``), SIGTERM handling
(``preemption``) and the epoch loop (``trainer``).  The CST slot rollout
and pipeline layout are not ported yet (ROADMAP.md Queue 1, item 1)."""
