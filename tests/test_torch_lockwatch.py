"""The port's dynamic lock-order harness (``analysis/lockwatch.py``):
instrumented locks under stub traffic through the port's
``ContinuousBatcher`` and ``ReplicaSet`` must give an ACYCLIC
acquisition graph — the runtime twin of the static CST-THR-001 rule.

The stubs are ``tests/test_torch_replicas.py``'s tick-budget engine and
decoder, so the traffic runs the real lock-bearing paths: admission
under the scheduler's condition, tick and harvest, metrics updates
inside and outside the lock, replica kill with requeue, drain and stop.
"""

import threading
import time

from cst_captioning_torch.analysis.lockwatch import InstrumentedLock, LockWatch
from cst_captioning_torch.serving.batcher import ContinuousBatcher
from cst_captioning_torch.serving.replicas import ReplicaSet

from test_torch_replicas import _StubDecoder, _StubEngine


class _SyncStubDecoder(_StubDecoder):
    """The synchronous API ``ContinuousBatcher`` drives, over the stub's
    async one (as ``SlotDecoder.tick`` / ``harvest_many`` are)."""

    _last = None

    def tick(self, prepared=(), datas=()):
        self._last = self.tick_begin(prepared, datas)
        return [] if self._last is None else self.tick_wait(self._last)

    def harvest_many(self, slots):
        return self.harvest_from(self._last, slots) if slots else []


class TestLockWatchUnit:
    def test_seeded_inversion_is_detected(self):
        """Two locks taken in both orders on two threads IS a cycle,
        even though this run did not deadlock."""
        watch = LockWatch()
        a = InstrumentedLock(watch)
        b = InstrumentedLock(watch)

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for fn in (ab, ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        cycles = watch.cycles()
        assert cycles and {a.label, b.label} <= set(cycles[0])
        try:
            watch.assert_acyclic()
        except AssertionError as e:
            assert "lock-order inversion" in str(e)
        else:
            raise AssertionError("assert_acyclic did not raise")
        assert watch.graph_size() == (2, 2)

    def test_consistent_order_is_acyclic(self):
        watch = LockWatch()
        a = InstrumentedLock(watch)
        b = InstrumentedLock(watch)
        for _ in range(3):
            with a:
                with b:
                    pass
        assert set(watch.edges) == {(a.label, b.label)}
        assert watch.acquisitions[a.label] == 3
        watch.assert_acyclic()

    def test_condition_wait_keeps_the_stack_truthful(self):
        """Condition.wait releases and reacquires through the
        instrumented lock, so a lock taken after the wait records no
        edge from the waited-on lock."""
        watch = LockWatch()
        with watch.patched():
            cond = threading.Condition()
        other = InstrumentedLock(watch)
        done = threading.Event()

        def waiter():
            with cond:
                cond.wait(timeout=5.0)
            with other:
                done.set()

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            cond.notify_all()
        t.join(timeout=5.0)
        assert done.is_set()
        watch.assert_acyclic()
        assert not {a for (a, b) in watch.edges if b == other.label}

    def test_patched_restores_the_constructors(self):
        real = (threading.Lock, threading.RLock, threading.Condition)
        watch = LockWatch()
        with watch.patched():
            assert isinstance(threading.Lock(), InstrumentedLock)
            assert isinstance(threading.RLock(), InstrumentedLock)
        assert (threading.Lock, threading.RLock,
                threading.Condition) == real


class TestContinuousBatcherLockOrder:
    def test_stub_traffic_acyclic(self):
        watch = LockWatch()
        with watch.patched():
            eng = _StubEngine(S=2)
            eng._decoder = _SyncStubDecoder(S=2)
            b = ContinuousBatcher(eng)
        with b:
            threads = [
                threading.Thread(target=lambda i=i: b.submit(
                    {"steps": 1 + (i % 3), "key": f"k{i}"}))
                for i in range(8)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=15.0)
        assert b.metrics.requests_served.value == 8
        assert sum(watch.acquisitions.values()) > 0
        assert watch.edges, "no nested acquisitions recorded"
        watch.assert_acyclic()


class TestReplicaSetLockOrder:
    def test_stub_traffic_with_kill_requeue_acyclic(self):
        """Admission and routing under the shared condition, the
        double-buffered tick / harvest, kill_replica with its in-flight
        work requeued onto the survivor, then drain: acyclic."""
        watch = LockWatch()
        with watch.patched():
            rs = ReplicaSet([_StubEngine(S=2), _StubEngine(S=2)])
        results, errors = [], []
        lock = threading.Lock()

        def go(steps):
            try:
                out = rs.submit({"steps": steps})
                with lock:
                    results.append(out)
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(e)

        rs.start()
        try:
            threads = [threading.Thread(target=go, args=(2 + (i % 4),))
                       for i in range(6)]
            for t in threads:
                t.start()
            time.sleep(0.02)          # some work lands on replica 0
            rs.kill_replica(0)        # drain + requeue
            more = [threading.Thread(target=go, args=(1,))
                    for _ in range(3)]
            for t in more:
                t.start()
            for t in threads + more:
                t.join(timeout=15.0)
        finally:
            rs.stop()
        assert not errors, errors
        assert len(results) == 9
        assert rs.healthy_replicas == 1
        assert sum(watch.acquisitions.values()) > 0
        assert watch.edges, "no nested acquisitions recorded"
        watch.assert_acyclic()
