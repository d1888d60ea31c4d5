# corpus-rules: shapeflow
"""Twin of the reference corpus's serving/dispatch_bad.py in the port's
idioms (line for line): a device tensor created with a
``len(...)``-derived leading dim in serving dispatch code — a launch
shape per distinct queue depth.  The negative case routes the count
through a ladder bucket function first (``bucket`` is a registered
quantizer name), which launders the taint."""

import torch


def storm_dispatch(requests, width):
    n = len(requests)
    # the raw count becomes a device shape
    bad = torch.zeros((n, width))  # expect: CST-SHP-001
    return bad


def laddered_dispatch(engine, requests, width):
    # negative: the count is quantized onto the ladder
    b = engine.bucket(len(requests))
    ok = torch.zeros((b, width))
    # negative: host-side numpy assembly never reaches a kernel
    import numpy as np

    host = np.zeros((len(requests), width))
    return ok, host
