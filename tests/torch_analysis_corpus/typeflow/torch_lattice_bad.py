# corpus-rules: dtypeflow
"""Torch's promotion and cast vocabulary on the traced surface: casts
spelled .to(device, dtype) / .type() / .to(other_tensor), a device move
that is no cast, integer tensors meeting float literals, and bare
products on a registered low-precision path (the test injects its
entry)."""

import torch
import torch.nn.functional as F


@torch.compile
def casts(x, other, dev):
    a = x.to(dev)                       # negative: a device move
    b = x.to(dev, torch.float16)  # expect: CST-DTY-001
    c = x.type(torch.float64)
    d = x.to(other)
    return a, b, c, d


@torch.compile
def int_meets_float(n):
    full = torch.full((4,), 1)          # int64: an int fill
    bad = full * 0.5  # expect: CST-DTY-002
    ids = torch.randint(0, 5, (3,), generator=None)
    bad2 = ids + 1.5  # expect: CST-DTY-002
    ok = torch.full((4,), 1.0) * 0.5    # negative: a float fill
    ok2 = ids * 2                       # negative: an int literal
    return bad, bad2, ok, ok2


@torch.compile
def low_precision_products(x, w, b, y):
    xc = x.to(torch.bfloat16)
    e = torch.einsum("bf,fe->be", xc, w)  # expect: CST-DTY-003
    lin = F.linear(xc, w, b)  # expect: CST-DTY-003
    bm = torch.bmm(xc, y)  # expect: CST-DTY-003
    ok = torch.matmul(xc.float(), w.float())   # negative: f32 operands
    return e, lin, bm, ok
