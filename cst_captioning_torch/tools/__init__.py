"""Offline tools of the port: the packed-feature converter and the
importer of JAX-trained checkpoints."""
