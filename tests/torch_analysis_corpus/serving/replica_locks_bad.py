# corpus-rules: thread_safety
# corpus-expect-anywhere: CST-THR-001
"""Seeded lock-order inversion and unguarded shared-state write in a
replica table: the per-replica workers take the table lock then the
stats lock, the operator's kill_replica takes them in the other order
(a latent deadlock), and kill_replica bumps a counter with no lock."""

import threading


class ReplicaTable:
    def __init__(self, n):
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.killed = 0
        self.served = 0
        self._threads = []
        for _ in range(n):
            self._threads.append(threading.Thread(target=self._worker))

    def _worker(self):
        with self._lock:
            with self._stats_lock:
                self.served += 1

    def kill_replica(self, i):
        self.killed += 1  # expect: CST-THR-002
        with self._stats_lock:
            with self._lock:
                return i


class SingleOwnerStats:
    """Negative: one thread owns this object by contract, so the
    unguarded writes from its thread and from submit do not fire."""

    _analysis_single_owner = True

    def __init__(self):
        self.n = 0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        self.n += 1

    def submit(self, x):
        self.n += x
