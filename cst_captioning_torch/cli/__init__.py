"""Command-line entry points of the port (``python -m
cst_captioning_torch.cli.{serve,train,test,pipeline}``)."""
