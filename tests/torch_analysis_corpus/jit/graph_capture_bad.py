# corpus-rules: jit_boundary, observability, resilience
"""The port's other traced roots: a TorchScript root, a CUDA-graph
capture body (and what it calls), and make_graphed_callables.  Host
state, tracer spans and chaos decisions inside them fire; host work
around them does not."""

import time

import torch


@torch.jit.script
def scripted(x):
    return x.cpu()  # expect: CST-JIT-001


def _captured_helper(x, tracer):
    tracer.record("request", 0.0, 1.0)  # expect: CST-OBS-003
    return x * 2


def capture(g, x, tracer, chaos):
    tracer.record("request", 0.0, 1.0)   # host side: no finding
    with torch.cuda.graph(g):
        y = _captured_helper(x, tracer)
        torch.cuda.synchronize()  # expect: CST-JIT-001
        if chaos is not None:
            chaos.fire("tick_stall")  # expect: CST-RES-003
    return y


def graphed_body(x, steps: int = 2, mode="greedy"):
    # negative: int / str parameters are guarded constants
    for _ in range(steps):
        x = x + 1
    if mode == "greedy":
        x = x * 2
    if x.sum() > 0:  # expect: CST-JIT-002
        x = x - 1
    return x.numpy()  # expect: CST-JIT-001


graphed = torch.cuda.make_graphed_callables(graphed_body, (torch.zeros(2),))


def host_only(x):
    # negative: no traced root reaches this
    print(x.item())
    return time.time()
