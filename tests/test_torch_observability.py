"""The port's span tracer, flight recorder, ``/debug`` endpoints and
training spans, held against the JAX package's ``observability/``.

The port keeps its own copy of the reference's stdlib-only tracer and
flight recorder: the catalogues must equal the reference's (but for the
``profile`` entry's help, which names ``torch.profiler``), the same
recorded spans must export to the same Chrome trace, and the port's
flight dumps must pass the reference's validator.  The HTTP surface
(``/debug/trace``, ``/debug/flight``, ``/debug/profile``) is driven on
the CPU over the single-engine slot loop at ``synthetic_smoke`` widths;
the profile window records CPU activities only on this host.  The CST
trainer's ``train.trace_file`` holds one ``cst/step`` span a step and a
``phase/*`` span for every ``phase_*`` key of ``history.json``;
``train.profile_dir`` writes a profiler trace.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cst_captioning_tpu.observability import flight as jflight
from cst_captioning_tpu.observability import trace as jtrace
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.observability import flight as tflight
from cst_captioning_torch.observability import trace as ttrace
from cst_captioning_torch.ops import _build
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.server import CaptionServer
from cst_captioning_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ catalogues

def test_catalogues_equal_the_reference_but_the_profile_help():
    assert ttrace.EVENT_CATALOGUE == jtrace.EVENT_CATALOGUE
    assert len(ttrace.SPAN_CATALOGUE) == len(jtrace.SPAN_CATALOGUE)
    for (p, c, h), (jp, jc, jh) in zip(ttrace.SPAN_CATALOGUE,
                                       jtrace.SPAN_CATALOGUE):
        assert (p, c) == (jp, jc)
        if p == "profile":
            assert "torch.profiler" in h and "jax" not in h
        else:
            assert h == jh, p


@pytest.mark.parametrize("name,ok", [
    ("request", True), ("phase/score", True), ("phase/", True),
    ("cst/step", True), ("tick", True), ("requests", False),
    ("phase", False), ("cst/other", False), ("warmup", False)])
def test_registered_names_match_the_reference(name, ok):
    assert ttrace.registered(name) is ok
    assert jtrace.registered(name) is ok


def test_unregistered_names_raise():
    tr = ttrace.Tracer()
    with pytest.raises(ValueError, match="not registered"):
        tr.record("no_such_span", 0.0, 1.0)
    with pytest.raises(ValueError, match="not registered"):
        tr.span("no_such_span")
    with pytest.raises(ValueError, match="not registered"):
        tflight.FlightRecorder("r").event("no_such_event")
    off = ttrace.Tracer(enabled=False)
    assert off.record("no_such_span", 0.0, 1.0) is None


# ---------------------------------------------------------------- export

def _record_fixed(mod):
    """The same spans, ids and times into a fresh tracer of ``mod``,
    from two threads."""
    tr = mod.Tracer()
    tr._t0 = 100.0
    tr.record("request", 100.5, 100.75, trace_id="t1", span_id="s1",
              tags={"status": 200})
    tr.record("queue", 100.5, 100.5625, trace_id="t1", span_id="s2",
              parent_id="s1", tags={"replica": 0})
    tr.record("phase/score", 101.0, 101.125, trace_id="t2", span_id="s3",
              parent_id="s4")

    def other():
        tr.record("tick_dispatch", 102.0, 102.001953125, trace_id="t3",
                  span_id="s5", tags={"seq": 7, "admits": 2})

    t = threading.Thread(target=other, name="worker-x")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    return tr


def test_chrome_export_equals_the_reference():
    mine = _record_fixed(ttrace).export_chrome_trace()
    ref = _record_fixed(jtrace).export_chrome_trace()
    assert mine == ref
    jtrace.validate_chrome_trace(mine)
    ttrace.validate_chrome_trace(mine)
    x = [e for e in mine["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in x] == ["request", "queue", "phase/score",
                                     "tick_dispatch"]
    assert x[1]["args"]["parent_id"] == "s1" and x[1]["ts"] == 500000.0


def test_span_nesting_and_thread_stress():
    """Nested spans link to their parent; 16 threads under a short
    switch interval lose no span and mix no trace ids."""
    tr = ttrace.Tracer(buffer_spans=10_000)
    with tr.span("request") as root:
        with tr.span("queue") as child:
            pass
    spans = {s["name"]: s for s in tr.spans()}
    assert spans["queue"]["parent_id"] == root.span_id
    assert spans["queue"]["trace_id"] == root.trace_id == child.trace_id
    tr.clear()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def emit(k):
            for i in range(200):
                tr.record("detok", i, i + 1, trace_id=f"k{k}",
                          tags={"i": i})

        ths = [threading.Thread(target=emit, args=(k,)) for k in range(16)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    got = list(tr.spans())
    assert len(got) == 16 * 200
    for k in range(16):
        mine = [s["tags"]["i"] for s in got if s["trace_id"] == f"k{k}"]
        assert mine == list(range(200))


# ---------------------------------------------------------------- flight

def test_flight_dump_passes_the_reference_validator(tmp_path):
    tr = ttrace.Tracer()
    tr.record("tick_wait", 1.0, 2.0, tags={"replica": 3})
    tr.record("tick_wait", 1.0, 2.0, tags={"replica": 4})
    rec = tflight.FlightRecorder("replica3", max_events=4,
                                 out_dir=str(tmp_path), tracer=tr,
                                 tags={"replica": 3})
    for i in range(6):
        rec.event("tick", seq=i, admits=1, occupied=2)
    rec.event("kill")
    snap = rec.snapshot()
    assert len(snap["events"]) == 4          # the ring is bounded
    jflight.validate_flight_dump(snap)
    path = rec.dump("replica 3 killed")
    with open(path) as f:
        body = json.load(f)
    jflight.validate_flight_dump(body)
    tflight.validate_flight_dump(body)
    assert body["reason"] == "replica 3 killed"
    assert [s["tags"]["replica"] for s in body["spans"]] == [3]
    assert rec.snapshot()["events"][-1]["event"] == "dump"
    assert tflight.FlightRecorder("x").dump("nothing") is None


# ------------------------------------------------- thread-safety repairs

def test_launch_counters_lose_no_update_under_threads():
    """Replica workers launch from several threads: the counters of the
    kernel wrappers add under a lock."""
    from cst_captioning_torch.ops.rowgemm import row_dot

    before = row_dot.launches, row_dot.quant_launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                _build.count_launch(row_dot)
                _build.count_launch(row_dot, "quant_launches")

        ths = [threading.Thread(target=bump) for _ in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    assert row_dot.launches - before[0] == 16000
    assert row_dot.quant_launches - before[1] == 16000
    row_dot.launches, row_dot.quant_launches = before


def test_wrappers_count_through_the_lock():
    """No wrapper bumps its counter with a bare ``+=``; the tanh table is
    filled under a mutex (CUDA only: a source check here)."""
    ops = os.path.join(REPO, "cst_captioning_torch", "ops")
    for name in ("attention", "attlstm", "beam", "lstm", "rowgemm",
                 "sampler"):
        with open(os.path.join(ops, f"{name}.py")) as f:
            src = f.read()
        assert "launches +=" not in src, name
        assert "_build.count_launch(" in src, name
    with open(os.path.join(REPO, "cst_captioning_torch", "csrc",
                           "context_common.cuh")) as f:
        src = f.read()
    body = src[src.index("static cudaError_t tanh_table_ready"):]
    body = body[:body.index("\n}\n")]
    assert "std::lock_guard<std::mutex>" in body
    assert body.index("lock_guard") < body.index("if (ready[dev])")


# ------------------------------------------------------------ /debug/*

def _engine(**serving):
    cfg = tcfg.get_preset("synthetic_smoke")
    sv = cfg.serving
    sv.continuous, sv.replicas, sv.warmup = True, 1, False
    sv.num_slots, sv.caption_cache_size = 4, 0
    for k, v in serving.items():
        setattr(sv, k, v)
    return InferenceEngine(cfg, random_init=True,
                           vocab=Vocabulary([f"w{i}" for i in range(40)]),
                           device="cpu")


def _payload(seed):
    rng = np.random.RandomState(seed)
    return {"features": {"resnet": rng.randn(4, 64).round(3).tolist()}}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/caption", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_debug_trace_and_flight(tmp_path):
    """A served request's X-Trace-Id leads to its root span and the
    scheduler's queue / admit / decode / detok spans under it; the
    engine's tick spans are there too; /debug/flight shows the tick
    ring; a drain writes a dump the reference's validator accepts."""
    ttrace.get_tracer().clear()
    srv = CaptionServer(_engine(flight_dir=str(tmp_path)), port=0).start()
    try:
        code, out, hdrs = _post(srv.url, _payload(1))
        assert code == 200 and isinstance(out["caption"], str)
        tid = hdrs["X-Trace-Id"]
        code, tr, _ = _get(srv.url + "/debug/trace")
        assert code == 200
        jtrace.validate_chrome_trace(tr)
        mine = {e["name"]: e for e in tr["traceEvents"]
                if e["ph"] == "X" and e["args"]["trace_id"] == tid}
        assert set(mine) == {"request", "queue", "admit", "decode", "detok"}
        root = mine["request"]["args"]["span_id"]
        assert all(mine[n]["args"]["parent_id"] == root
                   for n in ("queue", "admit", "decode", "detok"))
        names = {e["name"] for e in tr["traceEvents"] if e["ph"] == "X"}
        assert {"tick_dispatch", "tick_wait", "harvest"} <= names
        code, fl, _ = _get(srv.url + "/debug/flight")
        assert code == 200 and set(fl["recorders"]) == {"scheduler"}
        ring = fl["recorders"]["scheduler"]
        jflight.validate_flight_dump(ring)
        assert any(e["event"] == "tick" for e in ring["events"])
        code, stats, _ = _get(srv.url + "/stats")
        assert stats["latency_ms"]["total"]["exemplar"]["trace_id"] == tid
    finally:
        srv.shutdown()
    dumps = [p for p in os.listdir(tmp_path) if p.endswith("-drain.json")]
    assert len(dumps) == 1
    with open(os.path.join(tmp_path, dumps[0])) as f:
        body = json.load(f)
    jflight.validate_flight_dump(body)
    assert [e["event"] for e in body["events"]][-2:] == [
        "drain_start", "drain_exit"]


def test_debug_trace_is_404_with_tracing_off():
    srv = CaptionServer(_engine(tracing=False), port=0).start()
    try:
        code, out, hdrs = _post(srv.url, _payload(2))
        assert code == 200 and "X-Trace-Id" not in hdrs
        assert _get(srv.url + "/debug/trace")[0] == 404
        assert _get(srv.url + "/debug/flight")[0] == 200
    finally:
        srv.shutdown()


def test_debug_profile_status_codes(tmp_path):
    """404 without profile_dir; 400 for a bad window; 202 opens one, 409
    while it runs; the window's Chrome trace lands in profile_dir and a
    ``profile`` span in the tracer."""
    srv = CaptionServer(_engine(), port=0).start()
    try:
        assert _get(srv.url + "/debug/profile?ms=50")[0] == 404
    finally:
        srv.shutdown()
    prof = tmp_path / "profiles"
    srv = CaptionServer(_engine(profile_dir=str(prof)), port=0).start()
    try:
        for bad in ("ms=0", "ms=-5", "ms=60001", "ms=abc"):
            assert _get(srv.url + "/debug/profile?" + bad)[0] == 400, bad
        code, out, _ = _get(srv.url + "/debug/profile?ms=400")
        assert code == 202 and out["profiling_ms"] == 400.0
        assert _get(srv.url + "/debug/profile?ms=50")[0] == 409
        assert _post(srv.url, _payload(3))[0] == 200
        t0 = time.monotonic()
        while srv._http._profiling and time.monotonic() - t0 < 60:
            time.sleep(0.05)
        assert not srv._http._profiling
        files = os.listdir(prof)
        assert len(files) == 1 and files[0].endswith(".json")
        with open(prof / files[0]) as f:
            assert "traceEvents" in json.load(f)
        _, tr, _ = _get(srv.url + "/debug/trace")
        assert any(e["name"] == "profile" for e in tr["traceEvents"])
        assert _get(srv.url + "/debug/profile?ms=50")[0] == 202
    finally:
        srv.shutdown()


# -------------------------------------------------------------- training

def test_phase_clock_laps_are_spans():
    from cst_captioning_torch.training.steps import PhaseClock

    tr = ttrace.Tracer()
    clock = PhaseClock(tags={"layout": "split"}, tracer=tr)
    phases = {}
    for _ in range(2):
        clock.start()
        clock.lap("dispatch_ms")
        clock.lap("score_ms")
        clock.lap("score_ms")
        clock.commit(phases)
    spans = list(tr.spans())
    roots = [s for s in spans if s["name"] == "cst/step"]
    assert len(roots) == 2 and roots[0]["trace_id"] != roots[1]["trace_id"]
    for r in roots:
        kids = [s for s in spans if s["parent_id"] == r["span_id"]]
        assert [s["name"] for s in kids] == ["phase/dispatch", "phase/score",
                                             "phase/score"]
        assert all(s["trace_id"] == r["trace_id"]
                   and s["tags"] == {"layout": "split"} for s in kids)
        assert r["t0_s"] <= kids[0]["t0_s"] and kids[-1]["t1_s"] <= r["t1_s"]
    assert set(phases) == {"dispatch_ms", "score_ms", "total_ms"}


def test_trace_file_holds_the_cst_step_spans(tmp_path):
    """A 1-epoch CST fit with ``train.trace_file``: one ``cst/step`` span
    a step, and a ``phase/<name>`` span under it for every
    ``phase_<name>_ms`` of the epoch's history entry; each step's
    phase spans sum to at most its root's duration."""
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.train.max_epochs = 1
    cfg.train.train_mode = "cst"
    cfg.train.cst_baseline = "greedy"
    cfg.train.cst_num_samples = 2
    cfg.train.trace_file = str(tmp_path / "trace.json")
    cfg.name = "cst_trace"
    tr, _ = tbuild.build_dataset(cfg, "train")
    ttrace.get_tracer().clear()
    t = Trainer(cfg, tr, None, device="cpu")
    hist = t.fit()
    with open(cfg.train.trace_file) as f:
        trace = json.load(f)
    jtrace.validate_chrome_trace(trace)
    x = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    roots = [e for e in x if e["name"] == "cst/step"]
    steps = t.train_iter.num_batches()
    assert len(roots) == steps
    keys = {k[len("phase_"):-len("_ms")] for k in hist["0"]
            if k.startswith("phase_") and k != "phase_total_ms"}
    assert keys >= {"dispatch", "sample_fetch", "score", "greedy_fetch",
                    "update"}
    for r in roots:
        kids = [e for e in x if e["args"].get("parent_id")
                == r["args"]["span_id"]]
        assert {e["name"][len("phase/"):] for e in kids} == keys
        assert sum(e["dur"] for e in kids) <= r["dur"] + 1.0


def test_profile_dir_writes_a_training_trace(tmp_path):
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.train.max_epochs = 1
    cfg.train.profile_dir = str(tmp_path / "prof")
    cfg.train.profile_window_steps = 1
    cfg.name = "xe_profile"
    tr, _ = tbuild.build_dataset(cfg, "train")
    t = Trainer(cfg, tr, None, device="cpu")
    assert t.train_iter.num_batches() >= 2
    t.fit()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
