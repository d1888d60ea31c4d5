"""Offline tools of the port: the packed-feature converter."""
