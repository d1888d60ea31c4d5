"""Dynamic twin of the CST-THR-001 static rule: instrumented locks that
record the REAL acquisition order under traffic.

The static pass proves the lock graph acyclic for the paths it can see;
this harness proves it for the paths that actually ran.  Usage (the
pattern of tests/test_torch_lockwatch.py and chip_smoke phase 12b)::

    watch = LockWatch()
    with watch.patched():            # threading.Lock/RLock/Condition
        batcher = ContinuousBatcher(engine)   # builds instrumented locks
    batcher.start(); ...traffic...; batcher.stop()
    watch.assert_acyclic()           # raises listing any cycle

Locks created while patched stay instrumented after the context exits —
``patched()`` only bounds WHICH constructors are wrapped, not for how
long recording runs, so worker threads started later keep feeding the
graph.  Each lock is labelled with its construction site
(``file:line``); an edge A→B means some thread acquired B while holding
A, recorded with the acquiring site.  A cycle in that digraph is a
lock-order inversion: two threads interleaving those paths can deadlock
even if this run didn't.

The wrapper keeps a per-thread stack of held locks (reentrant RLock
holds collapse to one entry).  ``threading.Condition.wait`` releases
and reacquires through the lock object's own ``acquire``/``release``
(we pass a plain wrapped Lock, so the stdlib Condition uses exactly
those), which keeps the stack truthful across waits.
"""

from __future__ import annotations

import threading
import traceback
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


def _creation_site(skip_substrings=("lockwatch.py", "threading.py")) -> str:
    for frame in reversed(traceback.extract_stack()):
        fname = frame.filename
        if any(s in fname for s in skip_substrings):
            continue
        short = "/".join(fname.split("/")[-2:])
        return f"{short}:{frame.lineno}"
    return "<unknown>"


class InstrumentedLock:
    """A ``threading.Lock``/``RLock`` stand-in that reports every
    acquisition to its :class:`LockWatch`."""

    def __init__(self, watch: "LockWatch", reentrant: bool = False):
        self._watch = watch
        self._reentrant = reentrant
        self._lock = _REAL_RLOCK() if reentrant else _REAL_LOCK()
        self.label = f"{_creation_site()}#{watch._next_id()}"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._watch._before_acquire(self)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._watch._acquired(self)
        return got

    def release(self) -> None:
        self._lock.release()
        self._watch._released(self)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self._reentrant:  # RLock has no .locked() before 3.12
            raise AttributeError("locked() on an RLock wrapper")
        return self._lock.locked()

    # threading.Condition probes these on non-RLock locks; delegating
    # keeps wait() releasing through OUR release (stack stays truthful)
    def _is_owned(self) -> bool:
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True


class LockWatch:
    """Records the acquisition-order digraph over instrumented locks."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._mu = _REAL_LOCK()
        self._seq = 0
        # (held_label, acquired_label) -> sample acquisition site
        self.edges: Dict[Tuple[str, str], str] = {}
        self.acquisitions: Dict[str, int] = defaultdict(int)

    def _next_id(self) -> int:
        with self._mu:
            self._seq += 1
            return self._seq

    # ------------------------------------------------------ lock callbacks
    def _stack(self) -> List[InstrumentedLock]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _before_acquire(self, lock: InstrumentedLock) -> None:
        held = self._stack()
        if not held or any(h is lock for h in held):
            return  # nothing held, or a reentrant re-hold: no edge
        site = _creation_site()
        with self._mu:
            for h in held:
                if h.label != lock.label:
                    self.edges.setdefault((h.label, lock.label), site)

    def _acquired(self, lock: InstrumentedLock) -> None:
        held = self._stack()
        if self._reentrant_hold(held, lock):
            return
        held.append(lock)
        with self._mu:
            self.acquisitions[lock.label] += 1

    def _released(self, lock: InstrumentedLock) -> None:
        held = self._stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    @staticmethod
    def _reentrant_hold(
        held: List[InstrumentedLock], lock: InstrumentedLock
    ) -> bool:
        return lock._reentrant and any(h is lock for h in held)

    # ----------------------------------------------------------- patching
    @contextmanager
    def patched(self):
        """Swap ``threading.Lock``/``RLock``/``Condition`` for
        instrumented builders for the duration of the block.  Objects
        constructed inside keep recording after exit."""
        watch = self

        def make_lock():
            return InstrumentedLock(watch)

        def make_rlock():
            return InstrumentedLock(watch, reentrant=True)

        def make_condition(lock: Optional[object] = None):
            return _REAL_CONDITION(lock if lock is not None else make_lock())

        threading.Lock = make_lock            # type: ignore[assignment]
        threading.RLock = make_rlock          # type: ignore[assignment]
        threading.Condition = make_condition  # type: ignore[assignment]
        try:
            yield self
        finally:
            threading.Lock = _REAL_LOCK
            threading.RLock = _REAL_RLOCK
            threading.Condition = _REAL_CONDITION

    # ------------------------------------------------------------- verdict
    def graph_size(self) -> Tuple[int, int]:
        """``(nodes, edges)`` of the acquisition graph: every lock
        acquired at least once, and every held-then-acquired pair."""
        nodes = set(self.acquisitions)
        for a, b in self.edges:
            nodes.update((a, b))
        return len(nodes), len(self.edges)

    def cycles(self) -> List[List[str]]:
        graph: Dict[str, Set[str]] = defaultdict(set)
        for a, b in self.edges:
            graph[a].add(b)
            graph[b]
        out: List[List[str]] = []
        color: Dict[str, int] = {}
        path: List[str] = []

        def dfs(n: str) -> None:
            color[n] = 1
            path.append(n)
            for m in sorted(graph[n]):
                if color.get(m, 0) == 0:
                    dfs(m)
                elif color.get(m) == 1:
                    cyc = path[path.index(m):] + [m]
                    if not any(set(cyc) == set(c) for c in out):
                        out.append(cyc)
            path.pop()
            color[n] = 2

        for n in sorted(graph):
            if color.get(n, 0) == 0:
                dfs(n)
        return out

    def assert_acyclic(self) -> None:
        cyc = self.cycles()
        if cyc:
            lines = []
            for c in cyc:
                pairs = list(zip(c, c[1:]))
                lines.append(
                    " -> ".join(c)
                    + "  ("
                    + "; ".join(
                        f"{a}->{b} acquired at {self.edges[(a, b)]}"
                        for a, b in pairs
                        if (a, b) in self.edges
                    )
                    + ")"
                )
            raise AssertionError(
                "lock-order inversion observed under traffic:\n"
                + "\n".join(lines)
            )
