# corpus-rules: jit_boundary
"""Twin of the reference corpus's jit_host_state.py in the port's idioms
(line for line): host state inside torch.compile roots, transitive
callees, the traced-``if`` and set-iteration shapes."""

import functools
import time

import torch
import torch.nn.functional as F
import numpy as np


def _helper_with_clock(x):
    # traced TRANSITIVELY (called from bad_decorated below)
    t = time.monotonic()  # expect: CST-JIT-001
    return x + t


@torch.compile
def bad_decorated(x):
    print("tracing", x)  # expect: CST-JIT-001
    noise = np.random.rand()  # expect: CST-JIT-001
    y = _helper_with_clock(x) + noise
    if x > 0:  # expect: CST-JIT-002
        y = y * 2
    return y


@functools.partial(torch.compile, dynamic=False)
def static_arg_ok(x, flag: bool):
    # NEGATIVE case: `flag` is annotated a Python bool, a guarded
    # constant — branching on it must NOT fire CST-JIT-002
    if flag:
        return x + 1
    return x


@torch.compile
def bad_sync(x):
    v = x.sum().item()  # expect: CST-JIT-001
    return x / v


@torch.compile
def bad_set_iteration(x):
    total = x
    for axis in {0, 1}:  # expect: CST-JIT-003
        total = total.sum(dim=axis)
    return F.relu(total)


def jitted_by_call(x, y):
    if y is None:  # NEGATIVE: is-None tests are host-static
        y = torch.zeros_like(x)
    while x.ndim > 2:  # NEGATIVE: shape reads are host-static
        x = x.sum(0)
    if y:  # expect: CST-JIT-002
        x = x + y
    return x


run = torch.compile(jitted_by_call)
