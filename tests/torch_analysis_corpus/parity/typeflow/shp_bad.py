# corpus-rules: shapeflow
"""Twin of the reference corpus's typeflow/shp_bad.py in the port's
idioms (line for line): kernel sites with no SHAPE_LADDER_REGISTRY
entry (001), AOT enumeration drift in a class shipping the artifact
contract (002), and trace-time loop unrolls over ``.shape`` (003).  The
data-dependent half of 001 is seeded in ``serving/dispatch_bad.py``.
Negative cases: static-bound loops and a drift-free enumeration; a
kernel site here names no real library."""

import torch
from cst_captioning_torch.ops import _build

def unladdered_root(x):
    return _build.load("unladdered")  # expect: CST-SHP-001


@torch.compile
def shape_unroll(x):
    lib = _build.load("unroll")  # expect: CST-SHP-001
    acc = torch.zeros_like(x[0])
    # a Python loop over a traced tensor's length:
    # unrolls at trace time, once per shape: a per-shape graph blowup
    for t in range(x.shape[0]):  # expect: CST-SHP-003
        acc = acc + x[t]
    # negative: a small static bound is ordinary unrolling
    for _ in range(4):
        acc = acc * 1
    n = x.shape[0]
    # the read threads through the def-use chains too
    while n > 0:  # expect: CST-SHP-003
        acc = acc - 1
        n = n - 1
    return acc, lib


class DriftingArtifact:
    """aot_variant_keys / _variants disagree on every axis the rule
    checks: key families, runner reachability, ladder sources."""

    def __init__(self):
        self.bank_ladder = [8, 16]
        self._fns = {}

    def warm_admit_counts(self, bank):
        return [0, bank]

    def _tick_fn(self, a):
        return self._fns.setdefault(("tick", a), object())

    def _extra_fn(self, s):  # expect: CST-SHP-002
        # the runner of a variant kind warmup never reaches
        return self._fns.setdefault(("extra", s), object())

    def warmup(self):
        for bank in self.bank_ladder:
            for a in self.warm_admit_counts(bank):
                self._tick_fn(a)
        # (the "extra" variants are never warmed)

    # emits "free:" keys _variants never yields, and ignores the
    # bank_ladder / warm_admit_counts sources warmup walks
    def aot_variant_keys(self):  # expect: CST-SHP-002
        return [f"tick:A{a}" for a in (0, 8)] + ["free:S8"]

    def _variants(self):
        for a in (0, 8):
            yield f"tick:A{a}", ("tick", a)
        yield "extra:S8", ("extra", 8)


class CleanArtifact:
    """Negative: enumeration and warmup agree — no findings."""

    def __init__(self):
        self.bank_ladder = [8]

    def warm_admit_counts(self, bank):
        return [0, bank]

    def _tick_fn(self, a):
        return object()

    def warmup(self):
        for bank in self.bank_ladder:
            for a in self.warm_admit_counts(bank):
                self._tick_fn(a)

    def aot_variant_keys(self):
        return [key for key, _ in self._variants()]

    def _variants(self):
        for b in self.bank_ladder:
            for a in self.warm_admit_counts(b):
                yield f"tick:S{b}:A{a}", ("tick", b, a)
