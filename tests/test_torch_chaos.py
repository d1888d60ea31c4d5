"""Fault injection in the port (``serving/chaos.py`` and its sites in
``serving/batcher.py`` / ``serving/replicas.py``) against the JAX
package's, on the CPU.

* ``ChaosEngine``: the same seed, schedule and call sequence give the
  JAX engine's decision log; the schedule's validation and the
  off-by-default rule are the reference's.
* ``run_soak`` over the same stub schedulers (a request's tick budget
  rides its category, as in the reference's tests) gives the JAX
  ``run_soak``'s outcomes, decision log and fault log on the same traces
  and seeds, drives every fault site, loses nothing and leaves valid
  flight dumps; the requeue path keeps original deadlines.
* A soak over real engines (``synthetic_smoke``, two replicas on the CPU)
  with a replica kill and tick stalls loses nothing and serves every
  caption the chaos-free soak serves.
* Chaos off is the chaos-free path: no engine built, the same decisions.
* The static check, the reference's CST-RES-001 / 002 for the port: every
  ``chaos.fire("…")`` literal in the port's ``serving/`` names a
  ``FAULT_SITES`` entry, every entry has a site in each module it names,
  and every site sits behind a ``chaos is not None`` guard.
"""

import ast
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.serving import chaos as jchaos
from cst_captioning_tpu.serving import engine as jengine_mod
from cst_captioning_tpu.serving.cache import TwoTierCache as JaxCache
from cst_captioning_tpu.serving.metrics import ServingMetrics as JaxMetrics
from cst_captioning_tpu.serving.replicas import ReplicaSet as JaxReplicaSet
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.observability.flight import validate_flight_dump
from cst_captioning_torch.serving import chaos as tchaos
from cst_captioning_torch.serving import engine as tengine_mod
from cst_captioning_torch.serving.batcher import ContinuousBatcher
from cst_captioning_torch.serving.cache import TwoTierCache
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.metrics import PRIORITIES, ServingMetrics
from cst_captioning_torch.serving.replicas import ReplicaSet

REPO = Path(__file__).resolve().parent.parent
SERVING = REPO / "cst_captioning_torch" / "serving"


# ------------------------------------------------------ stub scheduler

class _StubDecoder:
    """The reference tests' async-API slot decoder double: a request's
    tick budget rides ``prepared.category``."""

    def __init__(self, S=2, block=1):
        self.S, self.K, self.L, self.block = S, 1, 10_000, block
        self.admit_cap = S
        self.free = list(range(S))
        self.occupied = {}
        self._remaining = {}
        self._admit_seq = {}
        self._seq = 0
        self.resize_count = 0

    @property
    def n_occupied(self):
        return len(self.occupied)

    def maybe_resize(self, pending=0):
        return self.S

    def live_state_bytes(self):
        return 64 * self.n_occupied

    def tick_begin(self, prepared=(), datas=()):
        for req, data in zip(prepared, datas):
            slot = self.free.pop()
            self.occupied[slot] = data
            self._remaining[slot] = req.category
            self._admit_seq[slot] = self._seq + 1
        if not self.occupied:
            return None
        self._seq += 1
        for s in self.occupied:
            self._remaining[s] -= self.block
        done = tuple(s for s in self.occupied if self._remaining[s] <= 0)
        return (self._seq, done)

    def tick_wait(self, handle):
        time.sleep(0.001)
        seq, done = handle
        return [s for s in done
                if s in self.occupied and self._admit_seq[s] <= seq]

    def harvest_from(self, handle, slots):
        seq, _ = handle
        out = []
        for s in slots:
            data = self.occupied.pop(s)
            steps = (seq - self._admit_seq.pop(s) + 1) * self.block
            self._remaining.pop(s, None)
            self.free.append(s)
            out.append((data, np.asarray([5, 2], np.int32), 0.0, steps))
        return out

    def evict(self, slot):
        data = self.occupied.pop(slot)
        self._remaining.pop(slot, None)
        self._admit_seq.pop(slot, None)
        self.free.append(slot)
        return data


class _StubEngine:
    def __init__(self, pkg, S=2, cfg=None):
        self.pkg = pkg
        self.cfg = cfg if cfg is not None else (
            jax_preset if pkg == "jax" else tcfg.get_preset)("synthetic_smoke")
        self.cache = (JaxCache if pkg == "jax" else TwoTierCache)(8, 8)
        self._decoder = _StubDecoder(S=S)
        self.device = None

    def prepare(self, payload):
        steps = int(payload.get("steps", 3))
        key = payload.get("key", "")
        if self.pkg == "jax":
            return jengine_mod.PreparedRequest(
                feats=None, masks=None, category=steps, feature_id=None,
                cache_key=key, enc_row=None)
        return tengine_mod.PreparedRequest(
            feats=None, masks=None, cache_key=key, category=steps)

    def lookup_caption(self, key):
        return self.cache.captions.get(key) if key else None

    def slot_decoder(self):
        return self._decoder

    def result_from_tokens(self, req, tokens, timings_ms, store=True):
        mod = jengine_mod if self.pkg == "jax" else tengine_mod
        return mod.DecodedResult(caption="chaos-stub",
                                 tokens=[int(t) for t in tokens],
                                 timings_ms=timings_ms)


def _world(pkg, n_replicas=2, S=1, flight_dir="", queue_depth=6):
    cfg = (jax_preset if pkg == "jax" else tcfg.get_preset)("synthetic_smoke")
    if flight_dir:
        cfg.serving.flight_dir = flight_dir
    engines = [_StubEngine(pkg, S=S, cfg=cfg) for _ in range(n_replicas)]
    return (JaxReplicaSet if pkg == "jax" else ReplicaSet)(
        engines, (JaxMetrics if pkg == "jax" else ServingMetrics)(),
        queue_depth=queue_depth)


def _payloads(n, steps=3):
    return [{"steps": steps, "key": f"chaos-{i}"} for i in range(n)]


MID_TRAFFIC_SCHEDULE = [
    {"site": "replica_kill", "at": 6, "replica": 0},
    {"site": "tick_stall", "every": 4, "replica": 1, "value": 0.03},
    {"site": "queue_burst", "every": 5, "value": 3},
    {"site": "cache_miss", "p": 0.25},
    {"site": "deadline_skew", "at": 9, "value": 0.0},
]


def _soak(pkg, seed, schedule=MID_TRAFFIC_SCHEDULE, flight_dir="",
          n_requests=40, **world):
    mod = jchaos if pkg == "jax" else tchaos
    trace = mod.make_diurnal_trace(seed, n_requests, 12, base_per_tick=1.0,
                                   burst_factor=5.0, period_ticks=24)
    rs = _world(pkg, flight_dir=flight_dir, **world)
    chaos = mod.ChaosEngine(seed=seed, schedule=schedule)
    return rs, mod.run_soak(rs, _payloads(12, steps=4), trace, chaos=chaos)


# --------------------------------------------------------- ChaosEngine

def test_decision_log_equals_jax():
    sched = [{"site": "tick_stall", "every": 3, "value": 0.05},
             {"site": "cache_miss", "p": 0.4},
             {"site": "replica_kill", "at": 5, "replica": 1},
             {"site": "queue_burst", "p": 0.3, "value": 2},
             {"site": "deadline_skew", "every": 7, "value": 0.5}]

    def drive(engine):
        for _ in range(30):
            engine.fire("tick_stall")
            engine.fire("cache_miss")
            engine.fire("deadline_skew")
            for rid in (0, 1):
                engine.fire("replica_kill", replica=rid)
                engine.fire("queue_burst", replica=rid)
        return engine.decision_log(), engine.describe()

    for seed in (0, 11, 12):
        got = drive(tchaos.ChaosEngine(seed=seed, schedule=sched))
        want = drive(jchaos.ChaosEngine(seed=seed, schedule=sched))
        assert got == want and got[0]
    assert tchaos.FAULT_SITES == jchaos.FAULT_SITES


def test_trace_equals_jax():
    for seed in (0, 5, 31):
        assert tchaos.make_diurnal_trace(seed, 60, 9) == [
            tchaos.RecordedRequest(**r.__dict__)
            for r in jchaos.make_diurnal_trace(seed, 60, 9)]


def test_off_by_default_for_every_preset():
    for name in tcfg.PRESETS:
        assert tchaos.ChaosEngine.from_config(
            tcfg.get_preset(name).serving) is None, name


@pytest.mark.parametrize("bad", [
    {"site": "tick_stall"},
    {"site": "tick_stall", "at": 1, "every": 2},
    {"site": "tick_stall", "at": -1},
    {"site": "tick_stall", "every": 0},
    {"site": "tick_stall", "p": 1.5},
    {"site": "tick_stall", "at": True},
    {"site": "nope", "at": 0},
    "not a dict",
])
def test_malformed_schedule_entries_rejected_as_jax(bad):
    for mod in (tchaos, jchaos):
        with pytest.raises(ValueError):
            mod.ChaosEngine(schedule=[bad])


def test_config_keys_and_unregistered_sites():
    class SV:
        chaos = {"seed": 1, "sched": []}

    with pytest.raises(ValueError, match="unknown serving.chaos"):
        tchaos.ChaosEngine.from_config(SV())
    with pytest.raises(ValueError, match="FAULT_SITES"):
        tchaos.ChaosEngine().fire("made_up_site")


# -------------------------------------------------------- the soak

@pytest.mark.parametrize("seed", [31, 32, 7])
def test_soak_equals_jax(seed):
    _, got = _soak("torch", seed)
    _, want = _soak("jax", seed)
    assert got.completed and want.completed
    assert got.outcomes == want.outcomes
    assert got.decisions == want.decisions and got.decisions
    assert got.chaos_log == want.chaos_log and got.chaos_log
    assert (got.ticks, got.kills, got.stall_ticks) == (
        want.ticks, want.kills, want.stall_ticks)
    for slo in (10, 30):
        assert got.attainment(slo) == want.attainment(slo)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_requeue_audit_equals_jax(seed):
    """Two kills mid-traffic and already-expired arrivals, three
    replicas: the same outcomes as the JAX soak, original deadlines kept
    through every requeue, expired requests shed with flight events."""
    sched = [{"site": "replica_kill", "at": 4, "replica": 0},
             {"site": "replica_kill", "at": 8, "replica": 1},
             {"site": "deadline_skew", "every": 6, "value": 0.0}]
    reports = {}
    for pkg in ("torch", "jax"):
        mod = jchaos if pkg == "jax" else tchaos
        trace = mod.make_diurnal_trace(100 + seed, 30, 10,
                                       base_per_tick=1.5, burst_factor=3.0)
        rs = _world(pkg, n_replicas=3, S=1, queue_depth=64)
        seen, deadlines = [], {}
        orig = rs.submit_async

        def tracking(payload, _orig=orig, **kw):
            out = _orig(payload, **kw)
            if not isinstance(out, dict):
                seen.append(out)
                deadlines[id(out)] = out.deadline
            return out

        rs.submit_async = tracking
        rep = mod.run_soak(rs, _payloads(10, steps=6), trace,
                           chaos=mod.ChaosEngine(seed=seed, schedule=sched))
        reports[pkg] = rep
        if pkg == "torch":
            assert rep.completed and rep.lost == 0 and rep.kills == 2
            assert any(p.requeues >= 1 for p in seen)
            assert all(p.deadline == deadlines[id(p)] for p in seen)
            expired = rs.metrics.requests_expired.value
            assert expired >= 1 and rep.count("expired") == expired
            shed = [e for ring in rs.flight_snapshot().values()
                    for e in ring["events"] if e["event"] == "shed"]
            assert len(shed) >= expired
    assert reports["torch"].decisions == reports["jax"].decisions
    assert reports["torch"].chaos_log == reports["jax"].chaos_log


def test_mid_traffic_soak_zero_lost_and_valid_flight_dumps(tmp_path):
    rs, report = _soak("torch", 31, flight_dir=str(tmp_path))
    assert report.completed and report.lost == 0
    assert report.kills >= 1 and report.stall_ticks >= 1
    assert len(report.outcomes) == 40 and report.served > 0
    att = report.attainment(slo_ticks=30)
    assert att["interactive"] >= att["best_effort"]
    assert rs.metrics.requeues_total.value >= 1
    assert sum(rs.metrics.shed(p).value for p in PRIORITIES) >= 1
    assert rs.metrics.chaos_faults.value == len(report.chaos_log)
    assert {s for s, *_ in report.chaos_log} == {
        s for s, _, _ in tchaos.FAULT_SITES}
    dumps = sorted(Path(tmp_path).glob("flight-*.json"))
    assert dumps
    for path in dumps:
        rec = validate_flight_dump(json.loads(path.read_text()))
        assert [e["event"] for e in rec["events"]]
    faults = [e for ring in rs.flight_snapshot().values()
              for e in ring["events"] if e["event"] == "chaos_fault"]
    assert {e["tags"]["site"] for e in faults} >= {
        "replica_kill", "tick_stall", "queue_burst"}


def test_no_chaos_parity():
    """A soak with no engine and one with an empty schedule give the
    same decisions; the empty engine never fires; the default config
    builds none."""
    trace = tchaos.make_diurnal_trace(5, 24, 8, base_per_tick=0.8,
                                      burst_factor=2.0)
    rs1 = _world("torch")
    off = tchaos.run_soak(rs1, _payloads(8, steps=4), trace)
    rs2 = _world("torch")
    empty = tchaos.ChaosEngine(seed=99, schedule=[])
    on = tchaos.run_soak(rs2, _payloads(8, steps=4), trace, chaos=empty)
    assert empty.decision_log() == []
    assert off.decisions == on.decisions
    assert rs2.metrics.chaos_faults.value == 0
    assert rs1.chaos is None


# ------------------------------------------------- the submit sites

def test_cache_miss_storm_forces_full_decode():
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.serving.chaos = {"seed": 0,
                         "schedule": [{"site": "cache_miss", "at": 1}]}
    eng = _StubEngine("torch", S=1, cfg=cfg)
    eng.cache.captions.put("chaos-hot", {"caption": "hot", "tokens": [5, 2]})
    rs = ReplicaSet([eng], ServingMetrics())
    assert rs.chaos is not None
    hit = rs.submit_async({"steps": 1, "key": "chaos-hot"})
    assert isinstance(hit, dict) and hit["cached"] is True
    missed = rs.submit_async({"steps": 1, "key": "chaos-hot"})
    assert not isinstance(missed, dict)
    assert rs.metrics.chaos_faults.value == 1
    assert "chaos_fault" in [e["event"] for e in rs.flight.snapshot()["events"]]


def test_deadline_skew_expires_at_admission():
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.serving.chaos = {"seed": 0, "schedule": [
        {"site": "deadline_skew", "at": 0, "value": 0.0}]}
    rs = ReplicaSet([_StubEngine("torch", S=1, cfg=cfg)], ServingMetrics())
    p = rs.submit_async({"steps": 1, "key": "skewed"})
    assert p.deadline <= p.t_enqueue


# ------------------------------------------------ real engines

def _real_engine(chaos=None, **serving):
    cfg = tcfg.get_preset("synthetic_smoke").replace(**{
        "serving.decode_mode": "greedy", "serving.continuous": True,
        "serving.warmup": False, "serving.num_slots": 4,
        "serving.slot_bank_min": 2, "serving.caption_cache_size": 0,
        **{f"serving.{k}": v for k, v in serving.items()}})
    if chaos is not None:
        cfg.serving.chaos = chaos
    return InferenceEngine(cfg, random_init=True, device="cpu",
                           vocab=Vocabulary([f"w{i}" for i in range(40)]))


def _real_payloads(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [{"features": {"resnet": (rng.randn(int(rng.randint(1, 8)), 64)
                                     * 2.0).astype(np.float32)}}
            for _ in range(n)]


def real_soak(engine, schedule, seed=3, n_requests=30, n_replicas=2,
              autoscaler=None, trace=None):
    """``run_soak`` over ``n_replicas`` clones of ``engine`` recording
    every served caption by request id: (report, {rid: tokens}, rs)."""
    rs = ReplicaSet.from_engine(engine, ServingMetrics(),
                                n_replicas=n_replicas)
    tokens = {}
    inner = rs._resolve_one

    def recording(p, eng, toks, *a, **kw):
        tokens.setdefault(id(p), []).append([int(t) for t in toks])
        return inner(p, eng, toks, *a, **kw)

    rs._resolve_one = recording
    seen = {}
    orig = rs.submit_async
    trace = trace or tchaos.make_diurnal_trace(seed, n_requests, 6,
                                               base_per_tick=1.0,
                                               burst_factor=4.0,
                                               period_ticks=16)
    arrivals = iter(sorted(trace, key=lambda r: (r.t_tick, r.rid)))

    def submit(payload, **kw):
        rid = next(arrivals).rid
        out = orig(payload, **kw)
        if not isinstance(out, dict):
            seen[rid] = out
        return out

    rs.submit_async = submit
    chaos = (tchaos.ChaosEngine(seed=seed, schedule=schedule)
             if schedule is not None else None)
    report = tchaos.run_soak(rs, _real_payloads(), trace, chaos=chaos,
                             autoscaler=autoscaler)
    served = {rid: tokens[id(p)][-1] for rid, p in seen.items()
              if id(p) in tokens}
    return report, served, rs


def test_real_engine_soak_with_kill_and_stall_loses_nothing():
    eng = _real_engine()
    sched = [{"site": "replica_kill", "at": 5, "replica": 0},
             {"site": "tick_stall", "every": 3, "replica": 1,
              "value": 0.02},
             {"site": "queue_burst", "every": 4, "value": 2},
             {"site": "cache_miss", "p": 0.5}]
    base, base_served, _ = real_soak(eng, None)
    rep, served, rs = real_soak(eng, sched)
    rep2, served2, _ = real_soak(eng, sched)
    assert base.lost == rep.lost == 0 and rep.completed
    assert rep.kills == 1 and rep.stall_ticks >= 1
    assert rs.metrics.requeues_total.value >= 1
    assert set(served) == set(base_served) and served
    for rid, toks in served.items():
        assert toks == base_served[rid], rid
    assert rep.decisions == rep2.decisions
    assert rep.chaos_log == rep2.chaos_log and served == served2


def test_continuous_batcher_sites_fire_and_serve():
    """The single-engine scheduler's sites: a stall and a burst fire,
    counted and flight-recorded, and the captions are the chaos-free
    scheduler's."""
    chaos = {"seed": 0, "schedule": [
        {"site": "tick_stall", "at": 1, "value": 0.01},
        {"site": "queue_burst", "at": 0, "value": 4}]}
    outs = {}
    for name, cfg in (("off", None), ("on", chaos)):
        eng = _real_engine(chaos=cfg, replicas=1)
        b = ContinuousBatcher(eng, ServingMetrics()).start()
        try:
            outs[name] = [b.submit(p)["tokens"] for p in _real_payloads()]
        finally:
            b.stop()
        if name == "on":
            assert b.chaos is not None and b.metrics.chaos_faults.value == 2
            sites = [e["tags"]["site"] for e in b.flight.snapshot()["events"]
                     if e["event"] == "chaos_fault"]
            assert sorted(sites) == ["queue_burst", "tick_stall"]
        else:
            assert b.chaos is None
    assert outs["on"] == outs["off"]


# ---------------------------------------------------- static check

def _fire_sites():
    """[(module, site literal, guarded)] for every ``*.fire("…")`` call
    on a chaos engine in the port's serving/."""
    out = []
    for path in sorted(SERVING.glob("*.py")):
        tree = ast.parse(path.read_text())
        parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire"
                    and "chaos" in ast.unparse(node.func.value)):
                continue
            assert node.args and isinstance(node.args[0], ast.Constant), (
                f"{path.name}: chaos.fire needs a literal site")
            guarded, cur = False, node
            while cur in parents:
                cur = parents[cur]
                test = (cur.test if isinstance(cur, ast.If)
                        else cur if isinstance(cur, ast.BoolOp) else None)
                if test is not None and "chaos is not None" in ast.unparse(
                        test):
                    guarded = True
                    break
            out.append((f"serving/{path.name}", node.args[0].value, guarded))
    return out


def test_every_fault_site_is_registered_live_and_guarded():
    sites = _fire_sites()
    names = {n for n, _, _ in tchaos.FAULT_SITES}
    assert sites
    for module, site, guarded in sites:
        assert site in names, (module, site)
        assert guarded, (module, site)
    for name, modules, _ in tchaos.FAULT_SITES:
        for module in (m.strip() for m in modules.split(",")):
            assert any(m == module and s == name for m, s, _ in sites), (
                name, module)
    assert [n for n, _, _ in tchaos.FAULT_SITES] == [
        n for n, _, _ in jchaos.FAULT_SITES]
    # Host-side only: the chaos module never touches torch.
    src = (SERVING / "chaos.py").read_text()
    assert "import torch" not in src and "jax" not in src
    assert os.path.exists(SERVING / "autoscaler.py")
