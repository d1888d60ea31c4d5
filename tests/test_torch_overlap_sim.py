"""The port's ``tools/overlap_sim.py``: ``credibility`` equal to the JAX
package's reduction, ``simulate`` on the CPU reporting every field the
reference's records, and rep escalation while noisy.  The timing
assertions stay loose (shared CPU hosts are noisy); the chunked step's
exactness is pinned by ``tests/test_torch_cst.py``."""

import pytest

from cst_captioning_tpu.tools import overlap_sim as josim
from cst_captioning_torch.tools import overlap_sim as tosim
from cst_captioning_torch.tools.overlap_sim import credibility, simulate

KEYS = (
    "cst_overlap_sim_dispatch_latency_ms",
    "cst_overlap_sim_rollout_compute_ms",
    "cst_overlap_sim_injected_scorer_ms",
    "cst_overlap_sim_k1_step_ms",
    "cst_overlap_sim_k2_step_ms",
    "cst_overlap_sim_recovered_ms",
    "cst_overlap_sim_recoverable_ms",
    "cst_overlap_sim_recovered_frac",
    "cst_overlap_sim_reps",
    "cst_overlap_sim_noisy",
)


@pytest.mark.parametrize("samples,recoverable", [
    ([50.0, 52.0, 51.0], 65.0),      # clean
    ([74.0, 75.0, 74.5], 65.0),      # above recoverable: clamped, noisy
    ([-5.0, -6.0], 65.0),            # negative: clamped, noisy
    ([10.0, 60.0, 110.0], 100.0),    # wide spread: noisy
    ([58.0, 60.0, 62.0], 65.0),      # tight spread
    ([30.0], 40.0),                  # one rep: no spread test
    ([3.0, 4.0], 0.0),               # nothing recoverable
    ([0.0, 0.0, 0.0], 10.0),         # zero recovery
])
def test_credibility_equals_the_reference(samples, recoverable):
    got = credibility(samples, recoverable)
    want = josim.credibility(samples, recoverable)
    assert got == want
    assert 0.0 <= got[1] <= 1.0
    assert isinstance(got[3], bool)


def test_credibility_flags_as_the_reference_cases():
    recovered, frac, raw, noisy = credibility([50.0, 52.0, 51.0], 65.0)
    assert abs(recovered - 51.0) < 1e-9
    assert 0.0 < frac < 1.0 and frac == raw and not noisy
    _, frac, raw, noisy = credibility([74.0, 75.0, 74.5], 65.0)
    assert raw > 1.0 and frac == 1.0 and noisy
    _, frac, raw, noisy = credibility([-5.0, -6.0], 65.0)
    assert raw < 0.0 and frac == 0.0 and noisy


def test_simulate_reports_all_fields():
    out = simulate(sleep_ms=8.0, chunks=2, steps=2, batch=8, rollouts=2,
                   reps=2, device="cpu")
    # Auto-escalation may raise reps beyond the requested 2 on a noisy
    # host, never lower them.
    assert out["cst_overlap_sim_reps"] >= 2
    assert "cst_overlap_sim_recovered_ms_sd" in out
    for key in KEYS:
        assert key in out, key
    assert out["cst_overlap_sim_injected_scorer_ms"] == 8.0
    # The injected scorer costs time: a K=1 step serializes all of it.
    assert out["cst_overlap_sim_k1_step_ms"] >= 8.0
    assert out["cst_overlap_sim_recoverable_ms"] == 4.0
    assert out["cst_overlap_sim_dispatch_latency_ms"] < 5.0
    assert 0.0 <= out["cst_overlap_sim_recovered_frac"] <= 1.0
    assert isinstance(out["cst_overlap_sim_noisy"], bool)


def test_simulate_auto_sizes_the_scorer(monkeypatch):
    monkeypatch.setenv("CST_OVERLAP_SIM_MAX_REPS", "1")
    out = simulate(sleep_ms=0.0, chunks=2, steps=1, batch=8, rollouts=2,
                   reps=1, device="cpu")
    assert out["cst_overlap_sim_injected_scorer_ms"] == round(
        out["cst_overlap_sim_rollout_compute_ms"], 1)
    assert out["cst_overlap_sim_reps"] == 1
    assert "cst_overlap_sim_recovered_ms_sd" not in out


def test_simulate_escalates_reps_when_noisy(monkeypatch):
    """Perpetual noisiness: simulate escalates up to the cap instead of
    recording 2 noisy reps."""
    monkeypatch.setenv("CST_OVERLAP_SIM_MAX_REPS", "4")
    monkeypatch.setattr(tosim, "credibility",
                        lambda pp, rec: (0.0, 0.0, 0.0, True))
    out = simulate(sleep_ms=5.0, chunks=2, steps=1, batch=8, rollouts=2,
                   reps=2, device="cpu")
    assert out["cst_overlap_sim_reps"] == 4
    assert out["cst_overlap_sim_noisy"] is True


def test_main_prints_one_line(capsys, monkeypatch):
    monkeypatch.setenv("CST_OVERLAP_SIM_MAX_REPS", "1")
    monkeypatch.setattr(tosim, "simulate",
                        lambda *a, **k: {"args": list(a), **k})
    assert tosim.main(["--chunks", "3", "--steps", "2", "--reps", "1"],
                      device="cpu") == 0
    import json

    line = json.loads(capsys.readouterr().out.strip())
    assert line == {"args": [0.0, 3, 2], "reps": 1, "device": "cpu"}
