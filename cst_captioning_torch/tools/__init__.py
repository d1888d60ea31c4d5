"""Offline tools of the port: data prep, the packed-feature converter
and the importer of JAX-trained checkpoints."""
