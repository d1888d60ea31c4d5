"""Seeded CST-RES violations: an unregistered fault site, an unguarded
injection point, and a chaos decision reachable from a compiled root.
Parsed, never imported."""
# corpus-rules: resilience

import torch


def unregistered_site(chaos):
    if chaos is not None:
        chaos.fire("spurious_site")                  # expect: CST-RES-001
    # negative: a registered site behind the same guard — must NOT fire
    if chaos is not None:
        chaos.fire("cache_miss")


def unguarded_fire(chaos):
    chaos.fire("tick_stall")                         # expect: CST-RES-002


def guarded_short_circuit(chaos):
    # negative: the `and` chain's left operand IS the guard
    if chaos is not None and chaos.fire("queue_burst"):
        return True
    return False


def guarded_truthiness(self):
    # negative: bare truthiness on a chaos-named attribute
    if self.chaos:
        self.chaos.fire("deadline_skew")


@torch.compile
def traced_fire(x, chaos):
    if chaos is not None:
        chaos.fire("replica_kill")                   # expect: CST-RES-003
    return x
