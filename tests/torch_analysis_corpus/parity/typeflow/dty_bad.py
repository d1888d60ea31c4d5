# corpus-rules: dtypeflow
"""Twin of the reference corpus's typeflow/dty_bad.py in the port's
idioms (line for line): an unregistered cast in traced code (001), a
proven integer tensor meeting a float literal (002), bare products on a
registered low-precision path (003; the test injects the entry for
``registered_low_precision``), and an in-place update on a cast of the
state inside a registered update step (004; the test injects
``donated_step``'s entry).  Negative cases stay quiet: registered casts,
float-side literals, the pinned product, bool masks, host code."""

import torch
from cst_captioning_torch.ops.rnn import dot_f32


@torch.compile
def unregistered_cast(x):
    # a precision change on the traced surface, with no
    # CAST_REGISTRY entry saying which parity tier survives it
    return x.to(torch.bfloat16)  # expect: CST-DTY-001


@torch.compile
def weak_promotion(logits):
    tok = torch.arange(8)
    # the interpreter PROVES tok is an int64 tensor; the bare float
    # literal silently floats it to the default float
    bad = tok * 0.5  # expect: CST-DTY-002
    # a second same-symbol violation: the baseline diff is count-aware
    bad2 = 2.5 - tok  # expect: CST-DTY-002
    # negative: float tensor x literal keeps its dtype
    ok = torch.zeros((8,), dtype=torch.float32) * 0.5
    # negative: bool masks scaled by literals are idiomatic
    mask = tok > 3
    okm = mask * 1.0
    return bad, ok, okm


@torch.compile
def registered_low_precision(x, w):
    # the cast itself is registered (entry injected by the test) ...
    xc = x.to(torch.bfloat16)
    # ... but products on a low-precision path must accumulate in f32
    bad_op = xc @ w  # expect: CST-DTY-003
    bad_call = torch.matmul(xc, w)  # expect: CST-DTY-003
    good = dot_f32(xc, w, torch.bfloat16)
    return bad_op + bad_call + good


def donated_step(state, batch):
    # an in-place update on a cast of the state: on a bf16 leaf the
    # cast is a temporary, and the state is silently unchanged
    state.float().add_(batch)  # expect: CST-DTY-001, CST-DTY-004
    return state

donated = torch.compile(donated_step)


def undonated_step(state, batch):
    # negative: the same cast in no update step -> only DTY-001
    # territory (traced, unregistered)
    return state.float() + batch  # expect: CST-DTY-001


undonated = torch.compile(undonated_step)


def host_helper(x):
    # negative: NOT reachable from any root -> no DTY-001
    return x.double()
