# corpus-rules: observability
"""A wall clock outside the observability layer fires only in a
function that also emits spans."""

import time


class Trainer:
    def cst_step(self):
        t0 = time.time()  # expect: CST-OBS-001
        with self.tracer.span("cst/step"):
            return t0

    def throughput(self, n):
        # negative: a wall clock with no span emission
        return n / max(time.time(), 1.0)
