# corpus-rules: resilience
"""Seeded fault-injection hazards against the package's FAULT_SITES: an
unguarded fire and an unregistered site, beside the guarded shapes the
port's scheduler uses."""


class Scheduler:
    def tick(self):
        if self.chaos is not None and self.chaos.fire("tick_stall"):
            return None
        self._chaos.fire("queue_burst")  # expect: CST-RES-002
        if self.chaos:
            self.chaos.fire("nccl_timeout")  # expect: CST-RES-001
        return None
