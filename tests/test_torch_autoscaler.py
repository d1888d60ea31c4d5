"""The elastic autoscaler of the port (``serving/autoscaler.py`` and its
wiring in ``serving/server.py``) against the JAX package's, on the CPU.

* ``observe`` gives the JAX policy's decisions over the same recorded
  signal windows (designed edge cases and seeded random streams); the
  configuration's validation is the reference's;
* in the virtual-time soak over the stub schedulers of
  ``test_torch_chaos`` the decision log, outcomes and requeues equal the
  JAX soak's: a burst scales up through ``add_replica``, the quiet tail
  scales down through ``kill_replica`` and the inline drain, nothing is
  lost, and a replay is identical;
* over real engines (``synthetic_smoke``, the ``CaptionServer``'s own
  scale-up factory, ``clone_for_device``) a burst-then-quiet trace scales
  1 -> 2 -> 1 with zero lost and every caption the static fleet's;
* the live thread starts and stops clean; the metric families and the
  ``autoscale`` flight event carry each applied decision.
"""

import time

import numpy as np
import pytest

from cst_captioning_tpu.config import PRESETS as JAX_PRESETS
from cst_captioning_tpu.serving import autoscaler as jas
from cst_captioning_tpu.serving import chaos as jchaos
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.serving import autoscaler as tas
from cst_captioning_torch.serving import chaos as tchaos
from cst_captioning_torch.serving.replicas import ReplicaSet
from cst_captioning_torch.serving.server import CaptionServer

from test_torch_chaos import (
    _StubEngine,
    _payloads,
    _real_engine,
    _world,
    real_soak,
)


def _sig(mod, queued=0, occupied=0, slots=1, healthy=1, shed=0, p99=0.0):
    return mod.Signals(queued=queued, occupied=occupied, slots=slots,
                       healthy=healthy, shed=shed, queue_wait_p99_ms=p99)


def _designed():
    q = dict(queued=0, occupied=0, slots=4, healthy=2)
    return [dict(queued=8), dict(shed=0), dict(shed=2), dict(queued=50,
            healthy=3), q, q, q, dict(queued=3, occupied=4, slots=4,
            healthy=2), q, q, q, q, dict(healthy=0), dict(p99=500.0), q]


def _random(seed, n=200):
    rng = np.random.RandomState(seed)
    shed = 0
    out = []
    for _ in range(n):
        shed += int(rng.rand() < 0.1) * int(rng.randint(1, 3))
        healthy = int(rng.randint(0, 4))
        slots = 4 * max(healthy, 1)
        quiet = rng.rand() < 0.5
        out.append(dict(queued=0 if quiet else int(rng.randint(0, 20)),
                        occupied=int(rng.randint(0, slots + 1)) if not quiet
                        else int(rng.randint(0, 2)),
                        slots=slots, healthy=healthy, shed=shed,
                        p99=float(rng.rand() * 300)))
    return out


@pytest.mark.parametrize("stream", ["designed", "random0", "random1",
                                    "random2"])
@pytest.mark.parametrize("cfg", [
    dict(min_replicas=1, max_replicas=3, window_ticks=3,
         scale_up_queue_depth=4.0, cooldown_ticks=4,
         scale_down_occupancy=0.5),
    dict(min_replicas=2, max_replicas=4, window_ticks=1, cooldown_ticks=0,
         scale_up_shed=0, scale_up_wait_p99_ms=200.0),
])
def test_observe_equals_jax(stream, cfg):
    sigs = _designed() if stream == "designed" else _random(int(stream[-1]))
    mine = tas.Autoscaler(tas.AutoscaleConfig(**cfg), lambda: None)
    ref = jas.Autoscaler(jas.AutoscaleConfig(**cfg), lambda: None)
    got = [tuple(mine.observe(_sig(tas, **s))) for s in sigs]
    want = [tuple(ref.observe(_sig(jas, **s))) for s in sigs]
    assert got == want
    assert {d[0] for d in got} >= {"hold", "up"}


def test_config_validation_is_the_reference():
    for name in tcfg.PRESETS:
        assert tas.AutoscaleConfig.from_config(
            tcfg.get_preset(name).serving) is None, name
    assert set(tcfg.PRESETS) <= set(JAX_PRESETS)

    class S:
        autoscale = {"max_replicas": 2, "scale_up_qeue_depth": 1}

    for mod in (tas, jas):
        with pytest.raises(ValueError, match="scale_up_qeue_depth"):
            mod.AutoscaleConfig.from_config(S())
        with pytest.raises(ValueError, match="max_replicas"):
            mod.AutoscaleConfig(min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="min_replicas"):
            mod.AutoscaleConfig(min_replicas=0)
    assert tas._KNOWN_KEYS == jas._KNOWN_KEYS


# ---------------------------------------------------- virtual time

def _scaler_soak(pkg, seed, n_reqs=30, **cfg_kw):
    mod, cmod = (jas, jchaos) if pkg == "jax" else (tas, tchaos)
    trace = cmod.make_diurnal_trace(seed, n_reqs, 10, base_per_tick=1.5,
                                    burst_factor=5.0, period_ticks=24)
    rs = _world(pkg, n_replicas=1, queue_depth=64)
    cfg = mod.AutoscaleConfig(**{
        "min_replicas": 1, "max_replicas": 3, "window_ticks": 2,
        "scale_up_queue_depth": 2.0, "cooldown_ticks": 3,
        "scale_down_occupancy": 0.9, **cfg_kw})
    scaler = mod.Autoscaler(cfg, lambda: _StubEngine(pkg, S=1))
    report = cmod.run_soak(rs, _payloads(10, steps=4), trace,
                           autoscaler=scaler)
    return rs, scaler, report


@pytest.mark.parametrize("seed", [11, 23, 4])
def test_soak_with_scaler_equals_jax(seed):
    rs, scaler, got = _scaler_soak("torch", seed)
    jrs, jscaler, want = _scaler_soak("jax", seed)
    assert scaler.decision_log() == jscaler.decision_log()
    assert got.outcomes == want.outcomes and got.decisions == want.decisions
    assert len(rs.replicas) == len(jrs.replicas)
    assert rs.metrics.requeues_total.value == jrs.metrics.requeues_total.value
    assert got.completed and got.lost == 0 and len(got.outcomes) == 30
    log = scaler.decision_log()
    assert all(e[4] <= 3 for e in log) and rs.healthy_replicas <= 3
    ticks = [e[0] for e in log]
    assert all(b - a > 3 for a, b in zip(ticks, ticks[1:]))
    _, again, _ = _scaler_soak("torch", seed)
    assert again.decision_log() == log


def test_burst_scales_up_and_quiet_scales_down():
    rs, scaler, report = _scaler_soak("torch", 23)
    assert {e[1] for e in scaler.decision_log()} == {"up", "down"}
    assert rs.metrics.autoscale_ups.value == sum(
        e[1] == "up" for e in scaler.decision_log())
    assert rs.metrics.autoscale_downs.value == sum(
        e[1] == "down" for e in scaler.decision_log())
    assert report.lost == 0


def test_scale_down_drain_loses_nothing():
    """A scale-down with work in flight on the victim (the highest
    healthy replica) requeues it onto the survivor, which serves it."""
    rs = _world("torch", n_replicas=2, queue_depth=64)
    scaler = tas.Autoscaler(tas.AutoscaleConfig(
        min_replicas=1, max_replicas=3, window_ticks=2, cooldown_ticks=0,
        scale_down_occupancy=1.0), lambda: _StubEngine("torch", S=1))
    p = rs.submit_async({"steps": 20, "key": "drain-me"})
    with rs._cond:
        for rep in rs.replicas:
            if p in rep.q:
                rep.q.remove(p)
        p.rid = 1
    dec1 = rs.replicas[1].decoder
    dec1.tick_begin([p.prepared], [p])
    assert dec1.n_occupied == 1
    d1 = scaler.step(rs, drain_inline=True)
    d2 = scaler.step(rs, drain_inline=True)
    assert (d1.action, d2.action) == ("hold", "down")
    assert not rs.replicas[1].healthy
    assert rs.metrics.requeues_total.value == 1
    rep0 = rs.replicas[0]
    for _ in range(40):
        if p.future.done():
            break
        with rs._cond:
            admits = [rep0.q.popleft() for _ in range(
                min(len(rep0.q), len(rep0.decoder.free)))]
        handle = rep0.decoder.tick_begin([x.prepared for x in admits], admits)
        if handle is None:
            continue
        done = rep0.decoder.tick_wait(handle)
        if done:
            rs._resolve(rep0, rs.metrics.replica(0),
                        rep0.decoder.harvest_from(handle, done))
    assert p.future.result()["caption"] == "chaos-stub"
    assert rs.metrics.autoscale_downs.value == 1


def test_flight_events_and_metric_families():
    rs, scaler, _ = _scaler_soak("torch", 11)
    events = [e for e in rs.flight.snapshot()["events"]
              if e["event"] == "autoscale"]
    assert len(events) == len(scaler.decision_log()) >= 1
    assert events[0]["tags"]["action"] in ("up", "down")
    assert {"reason", "frm", "to", "replica"} <= set(events[0]["tags"])
    text = rs.metrics.to_prometheus()
    for fam in ("caption_autoscale_decisions_total",
                "caption_autoscale_scale_ups_total",
                "caption_autoscale_scale_downs_total",
                "caption_autoscale_target_replicas",
                "caption_chaos_faults_total"):
        assert f"# HELP {fam} " in text and f"\n{fam} " in text
    d = rs.metrics.to_dict()
    assert d["autoscale"]["scale_ups"] >= 1
    assert d["autoscale"]["decisions"] >= 1
    assert d["degradation"]["chaos_faults"] == 0


def test_live_control_thread_steps_and_stops_clean():
    rs = _world("torch", n_replicas=1)
    scaler = tas.Autoscaler(tas.AutoscaleConfig(
        window_ticks=1, cooldown_ticks=0, interval_s=0.01,
        scale_up_queue_depth=1e9), lambda: _StubEngine("torch", S=1))
    scaler.start(rs)
    assert scaler.start(rs) is scaler
    deadline = time.monotonic() + 5.0
    while (rs.metrics.autoscale_decisions.value < 3
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert rs.metrics.autoscale_decisions.value >= 3
    scaler.stop()
    settled = rs.metrics.autoscale_decisions.value
    time.sleep(0.06)
    assert rs.metrics.autoscale_decisions.value == settled
    assert len(rs.replicas) == 1


# ---------------------------------------------------- real engines

def _burst_then_quiet():
    """16 arrivals over the first 4 ticks, then one every 25 ticks."""
    out = [tchaos.RecordedRequest(rid=i, t_tick=i // 4, key=i % 6)
           for i in range(16)]
    out += [tchaos.RecordedRequest(rid=16 + j, t_tick=30 + 25 * j,
                                   key=j % 6) for j in range(4)]
    return out


def test_server_autoscaler_scales_real_engines_exactly():
    auto = {"min_replicas": 1, "max_replicas": 2, "window_ticks": 2,
            "scale_up_queue_depth": 2.0, "cooldown_ticks": 3,
            "scale_down_occupancy": 0.9}
    eng = _real_engine(replicas=1, autoscale=auto)
    srv = CaptionServer(eng, port=0, batcher=ReplicaSet.from_engine(
        eng, n_replicas=1))
    try:
        assert srv.autoscaler is not None
        assert srv.autoscaler.cfg.max_replicas == 2
        clone = srv.autoscaler.engine_factory()
        assert clone.model is eng.model and clone.replica_id == 1
    finally:
        srv.shutdown(drain=False)
    assert CaptionServer(_real_engine(replicas=1, autoscale=auto),
                         port=0).autoscaler is None    # no fleet to size

    trace = _burst_then_quiet()
    static, static_served, _ = real_soak(eng, None, n_replicas=1,
                                         trace=trace)
    scaler = tas.Autoscaler(tas.AutoscaleConfig(**auto),
                            lambda: eng.clone_for_device(
                                eng.device, replica_id=None))
    rep, served, rs = real_soak(eng, None, n_replicas=1, trace=trace,
                                autoscaler=scaler)
    log = scaler.decision_log()
    assert [e[1] for e in log][:2] == ["up", "down"], log
    assert len(rs.replicas) == 2 and rs.healthy_replicas == 1
    assert rs.replicas[1].engine.replica_id == 1
    assert rep.lost == static.lost == 0 and rep.completed
    assert {o["replica"] for o in rep.outcomes.values()} == {0, 1}
    assert set(served) == set(static_served) == set(range(20))
    for rid, toks in served.items():
        assert toks == static_served[rid], rid
