# corpus-rules: shapeflow
"""The shape rules in the port's spellings: a varargs creator shaped by
a request count, a kernel site with no ladder entry, a slot-loop
variant kind no method runs, a TorchScript loop over ``x.size(0)``.
A config list's length is a knob, not data: it stays quiet."""

import torch

from cst_captioning_torch.ops import _build


def admit_rows(self, batch):
    rows = torch.empty(len(batch), 8)  # expect: CST-SHP-001
    frames = torch.zeros(len(self.cfg.data.feature_modalities), 8)
    return rows, frames, _build.load("row_gemm")  # expect: CST-SHP-001


class Slots:
    def __init__(self):
        self.bank_ladder = [8, 16]

    def tick(self, reqs):
        return reqs

    def warmup(self):
        for bank in self.bank_ladder:
            self.tick([bank])

    def aot_variant_keys(self):
        return [key for key, _ in self._variants()]

    def _variants(self):
        for bank in self.bank_ladder:
            yield f"tick:S{bank}", ("tick", bank)
            yield f"free:S{bank}", ("free", bank)  # expect: CST-SHP-002


@torch.jit.script
def unrolled(x):
    for i in range(x.size(0)):  # expect: CST-SHP-003
        x = x + i
    return x
