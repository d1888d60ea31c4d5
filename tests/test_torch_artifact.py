"""Serving artifacts of the port (``serving/artifact.py``,
``cli/build_artifact.py``, ``InferenceEngine.from_artifact``) on the CPU,
where an engine ships no kernel library (its wrappers run their plain
versions) and so the manifest, the refusals, the ladder and the tokens
are what is held here; the boot from the shipped ``sm_90a`` libraries
with no ``nvcc`` run is ``chip_smoke.py``'s phase 10.

One JAX engine (``synthetic_smoke``, meanpool, greedy, the slot loop at
banks 8 and 16, spread weights, as ``test_torch_slots`` builds it) is
the reference: its slot-loop tokens for twelve staggered requests, and
its ``SlotDecoder``'s variant keys and encode buckets for every ladder
setting.  The port's engines take its weights through the bridge.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.serving import slots as jslots
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.ops import _build
from cst_captioning_torch.serving import artifact as tart
from cst_captioning_torch.serving import autoscaler as tas
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.slots import SlotDecoder
from cst_captioning_torch.training.checkpoint import load_params_file

from test_torch_autoscaler import _burst_then_quiet
from test_torch_chaos import _real_engine, real_soak
from test_torch_slots import (
    N_REQ,
    _cfg,
    _drive,
    _payloads,
    _port_engine,
    _spread,
)

# The reference's manifest keys (serving/artifact.py: the content core,
# artifact_version, config, built_utc); the port adds `kernels`.
REFERENCE_KEYS = {"schema", "fingerprint", "env", "variants",
                  "encode_variants", "serving_dtype", "scale_hashes",
                  "artifact_version", "config", "built_utc"}


@pytest.fixture(scope="module")
def ref():
    """The JAX engine (spread weights) and its slot-loop results."""
    jeng = JaxEngine(_cfg(jax_preset, "meanpool", "greedy"),
                     random_init=True)
    _spread(jeng, "greedy")
    reqs = [jeng.prepare(p) for p in _payloads()]
    return jeng, _drive(jeng.slot_decoder(), reqs, range(N_REQ))


def _publish(eng, root):
    out = tart.build_artifact(eng, str(root))
    assert out["rebuilt"] and out["kernels"] == []
    return out["path"]


def _boot(path, **kw):
    before = _build.nvcc_runs
    eng = InferenceEngine.from_artifact(str(path), device="cpu", **kw)
    assert _build.nvcc_runs == before and not _build._pinned
    return eng


def _tracked_drive(dec, reqs):
    """``_drive`` with every bank the decoder passed through."""
    banks = [dec.S]
    inner = dec.maybe_resize

    def resize(pending=0):
        s = inner(pending)
        if s != banks[-1]:
            banks.append(s)
        return s

    dec.maybe_resize = resize
    got = _drive(dec, reqs, range(N_REQ))
    for _ in range(dec.shrink_after):        # idle ticks: back down
        resize(0)
    return got, banks


def _engine(jeng, fusion, mode):
    """A warm port engine on the reference's weights (meanpool) or on
    the port's random init spread as ``_spread`` spreads the JAX one
    (attention, whose tree the meanpool reference lacks)."""
    if fusion == "meanpool":
        return _port_engine(jeng, fusion, mode)
    init = InferenceEngine(_cfg(get_preset, fusion, mode), random_init=True,
                           vocab=Vocabulary(jeng.vocab.idx_to_word[4:]),
                           device="cpu")
    sd = {k: v.clone() for k, v in init.model.state_dict().items()}
    sd["word_embed"] *= 10.0
    sd["lstm0_w"] *= 2.0
    sd["logit_w"] *= 3.0
    sd["logit_b"][2] += 1.0
    return InferenceEngine(init.cfg, params=sd, vocab=init.vocab,
                           device="cpu")


# ------------------------------------------------------------- publish

def test_publish_is_atomic_versioned_and_a_checkpoint(ref, tmp_path,
                                                     monkeypatch):
    jeng, _ = ref
    eng = _port_engine(jeng, "meanpool", "greedy")
    vdir = _publish(eng, tmp_path)
    assert os.path.basename(vdir).startswith("v")
    assert sorted(os.listdir(vdir)) == ["infos.json", "kernels",
                                        "manifest.json", "params.pt",
                                        "vocab.json"]
    assert os.listdir(os.path.join(vdir, "kernels")) == []
    again = tart.build_artifact(eng, str(tmp_path))
    assert again["path"] == vdir and again["rebuilt"] is False
    assert again["artifact_bytes"] == tart.artifact_bytes(vdir)
    # The artifact is a params-only checkpoint of the port.
    params = load_params_file(vdir)
    for k, v in eng.model.state_dict().items():
        assert torch.equal(params[k], v), k
    # A build that dies leaves no version and no temporary directory.
    other = _port_engine(jeng, "meanpool", "greedy", num_slots=8)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr("cst_captioning_torch.training.checkpoint."
                        "save_params", boom)
    with pytest.raises(OSError, match="disk full"):
        tart.build_artifact(other, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(vdir)]


def test_manifest_is_the_references_plus_kernels(ref, tmp_path):
    jeng, _ = ref
    eng = _port_engine(jeng, "meanpool", "greedy")
    man = tart.load_manifest(_publish(eng, tmp_path))
    assert set(man) == REFERENCE_KEYS | {"kernels"}
    assert set(man["fingerprint"]) == set(jeng.fingerprint()) - {
        "artifact_version"}
    assert man["fingerprint"]["mesh_shape"] == "1x1"
    assert man["fingerprint"]["params_tag"] == jeng.params_tag
    assert man["env"] == tart.environment_block("cpu")
    assert man["env"]["platform"] == "cpu" and man["kernels"] == {}
    assert man["serving_dtype"] == "f32" and man["scale_hashes"] == {}
    jdec = jeng.slot_decoder()
    assert set(man["variants"]) == set(jdec.aot_variant_keys())
    assert set(man["encode_variants"]) == {
        f"encode:B{b}" for b in jdec.aot_encode_buckets()}
    assert all(len(s) == 16 for s in man["variants"].values())
    core = {k: man[k] for k in man
            if k not in ("artifact_version", "config", "built_utc")}
    assert man["artifact_version"] == "v" + hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()).hexdigest()[:12]


LADDERS = {
    "fixed": dict(slot_bank_min=0, num_slots=8, max_batch=8),
    "elastic": dict(slot_bank_min=2, num_slots=8, max_batch=8),
    "admit_cap3_keep": dict(slot_bank_min=2, num_slots=8, max_batch=3,
                            zero_freed_slots=False),
    "wide_ladder": dict(slot_bank_min=1, num_slots=16, max_batch=5),
    "speculative_k3": dict(slot_bank_min=2, num_slots=8, max_batch=8,
                           speculative={"draft_k": 3, "draft_hidden": 16}),
    "speculative_k2_fixed": dict(slot_bank_min=0, num_slots=4, max_batch=8,
                                 zero_freed_slots=False,
                                 speculative={"draft_k": 2, "draft_hidden": 8}),
}


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_ladder_keys_equal_the_jax_slot_decoders(ref, ladder, monkeypatch):
    """``warm_admit_counts`` / ``aot_variant_keys`` / ``aot_encode_
    buckets`` equal the JAX ``SlotDecoder``'s for the same settings."""
    jeng, _ = ref
    sv = dict(LADDERS[ladder])
    max_batch = sv.pop("max_batch")
    for k, v in sv.items():
        monkeypatch.setattr(jeng.cfg.serving, k, v)
    monkeypatch.setattr(jeng, "max_batch", max_batch)
    if "speculative" in sv:
        # The JAX decoder only checks that the engine carries a draft.
        monkeypatch.setattr(jeng, "draft_params", {"stub": None},
                            raising=False)
    jdec = jslots.SlotDecoder(jeng)
    peng = _port_engine(jeng, "meanpool", "greedy",
                        max_batch_size=max_batch, batch_shapes=[],
                        **sv)
    pdec = SlotDecoder(peng)
    assert pdec.bank_ladder == jdec.bank_ladder
    for bank in pdec.bank_ladder:
        assert pdec.warm_admit_counts(bank) == jdec.warm_admit_counts(bank)
    assert pdec.aot_variant_keys() == jdec.aot_variant_keys()
    assert pdec.aot_encode_buckets() == jdec.aot_encode_buckets()
    ticks, enc = pdec.aot_signatures()
    assert list(ticks) == pdec.aot_variant_keys()
    assert list(enc) == [f"encode:B{b}" for b in pdec.aot_encode_buckets()]


# ---------------------------------------------------------------- boot

def test_boot_token_exact_vs_jax_and_warm_greedy(ref, tmp_path):
    """The booted greedy slot loop (banks 8 -> 16 -> 8) against the JAX
    engine's and a warm port engine's on the same weights: tokens equal,
    scores bitwise the warm engine's."""
    jeng, want = ref
    warm = _port_engine(jeng, "meanpool", "greedy")
    booted = _boot(_publish(warm, tmp_path))
    assert booted.params_tag == warm.params_tag == jeng.params_tag
    got_w = _drive(warm.slot_decoder(), [warm.prepare(p) for p in
                                         _payloads()], range(N_REQ))
    got_b, banks = _tracked_drive(booted.slot_decoder(),
                                  [booted.prepare(p) for p in _payloads()])
    assert banks[:3] == [8, 16, 8], banks
    for i in range(N_REQ):
        np.testing.assert_array_equal(got_b[i][0], want[i][0])
        np.testing.assert_array_equal(got_b[i][0], got_w[i][0])
        assert got_b[i][1:] == got_w[i][1:]


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_boot_bitwise_vs_warm_beam_across_grow_and_shrink(ref, fusion,
                                                          tmp_path):
    """Beam-4 slot loops (banks 2 -> 4 -> 2) and the ladder: the booted
    engine's tokens and scores are bitwise the warm engine's."""
    jeng, _ = ref
    warm = _engine(jeng, fusion, "beam")
    booted = _boot(_publish(warm, tmp_path))
    assert booted.cfg.model.feature_fusion == fusion
    got_w = _drive(warm.slot_decoder(), [warm.prepare(p) for p in
                                         _payloads()], range(N_REQ))
    got_b, banks = _tracked_drive(booted.slot_decoder(),
                                  [booted.prepare(p) for p in _payloads()])
    assert banks[:3] == [2, 4, 2], banks
    for i in range(N_REQ):
        np.testing.assert_array_equal(got_b[i][0], got_w[i][0])
        assert got_b[i][1] == got_w[i][1]
    reqs = [warm.prepare(p) for p in _payloads()[:5]]
    assert ([r.tokens for r in booted.decode_prepared(reqs, store=False)]
            == [r.tokens for r in warm.decode_prepared(reqs, store=False)])


def test_boot_identity_clones_and_serving_kernels(ref, tmp_path):
    jeng, _ = ref
    warm = _port_engine(jeng, "meanpool", "greedy")
    vdir = _publish(warm, tmp_path)
    booted = _boot(tmp_path, replica_id=3)       # the root: newest version
    version = os.path.basename(vdir)
    fp = booted.fingerprint()
    assert fp["artifact_version"] == version and fp["mesh_shape"] == "1x1"
    assert warm.fingerprint()["artifact_version"] == "warm"
    assert booted.replica_id == 3 and booted.cfg.serving.warmup
    clone = booted.clone_for_device("cpu", replica_id=4)
    assert clone.artifact_version == version
    assert clone.params_tag == booted.params_tag
    assert clone.describe()["build"]["artifact_version"] == version
    assert booted.serving_kernels() == ["lstm_sample", "row_gemm"]
    for fusion, mode, layers, cont, want in [
            ("meanpool", "beam", 1, True, ["lstm_beam", "row_gemm"]),
            ("attention", "beam", 1, True,
             ["context_attention", "lstm_beam", "row_gemm"]),
            ("attention", "greedy", 1, False, ["lstm_sample", "row_gemm"]),
            ("attention", "beam", 2, False,
             ["context_attention", "row_gemm"]),
            ("meanpool", "greedy", 2, True, ["row_gemm"])]:
        cfg = _cfg(get_preset, fusion, mode, continuous=cont)
        cfg.model.num_layers = layers
        eng = InferenceEngine(cfg, random_init=True, vocab=warm.vocab,
                              device="cpu")
        assert eng.serving_kernels() == want, (fusion, mode, layers, cont)


# ------------------------------------------------------------ refusals

def test_refusal_names_every_divergent_field(ref, tmp_path, monkeypatch):
    jeng, _ = ref
    vdir = _publish(_port_engine(jeng, "meanpool", "greedy"),
                    tmp_path / "src")
    bad = str(tmp_path / "bad" / os.path.basename(vdir))
    shutil.copytree(vdir, bad)
    man = tart.load_manifest(bad)
    man["schema"] = 99
    man["env"]["device_kind"] = "NVIDIA H100 80GB HBM3"
    man["env"]["torch_version"] = "0.0"
    man["fingerprint"]["version"] = "9.9"
    man["fingerprint"]["mesh_shape"] = "1x2"
    man["serving_dtype"] = "bf16"
    man["scale_hashes"] = {"logit_w_scale": "0" * 16}
    man["kernels"] = {"row_gemm": "0" * 16}
    first = sorted(man["variants"])[0]
    man["variants"][first] = "f" * 16
    man["encode_variants"]["encode:B64"] = "e" * 16
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        json.dump(man, f)
    # The live ladder drifted too: one admission count fewer at bank 16.
    real = SlotDecoder.warm_admit_counts
    monkeypatch.setattr(SlotDecoder, "warm_admit_counts", lambda self, b: [
        a for a in real(self, b) if (b, a) != (16, 8)])
    with pytest.raises(tart.ArtifactMismatchError) as e:
        _boot(bad)
    assert set(e.value.fields) == {
        "schema", "env.device_kind", "env.torch_version",
        "fingerprint.version", "fingerprint.mesh_shape", "serving_dtype",
        "scale_hashes", "kernels.row_gemm", "kernels", "variants",
        "encode_variants"}
    drift = dict((f, (a, b)) for f, a, b in e.value.mismatches)["variants"]
    assert first in drift[0] and "tick:S16:A8" in drift[0]
    assert "tick:S16:A8" not in drift[1]
    for f in e.value.fields:
        assert f in str(e.value)
    assert isinstance(e.value, tart.ArtifactError)


def test_malformed_artifacts_raise_artifact_error(ref, tmp_path):
    jeng, _ = ref
    vdir = _publish(_port_engine(jeng, "meanpool", "greedy"),
                    tmp_path / "src")
    with pytest.raises(tart.ArtifactError, match="no artifact"):
        _boot(tmp_path / "missing")
    os.makedirs(tmp_path / "crashed" / ".tmp-v1-1")
    with pytest.raises(tart.ArtifactError, match="no published"):
        _boot(tmp_path / "crashed")

    def broken(name, edit):
        d = str(tmp_path / name)
        shutil.copytree(vdir, d)
        edit(d)
        return d

    def drop_key(d):
        man = tart.load_manifest(d)
        del man["kernels"]
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(man, f)

    def truncate(d, name):
        p = os.path.join(d, name)
        with open(p, "rb") as f:
            data = f.read()
        with open(p, "wb") as f:
            f.write(data[: len(data) // 3])

    for d, match in [
            (broken("nokey", drop_key), "missing key 'kernels'"),
            (broken("nojson", lambda d: truncate(d, "manifest.json")),
             "unreadable manifest"),
            (broken("noparams", lambda d: truncate(d, "params.pt")),
             "unreadable artifact")]:
        with pytest.raises(tart.ArtifactError, match=match):
            _boot(d)
    # The kernel libraries: never built, never taken from _kernels_build.
    kdir = tmp_path / "kernels"
    kdir.mkdir()
    live = _build.kernel_digest("row_gemm")
    runs = _build.nvcc_runs
    for digests, match in [
            ({"row_gemm": live}, "missing"),
            ({"row_gemm": "0" * 16}, "live sources give"),
            ({"flash_attention": live}, "not one of")]:
        with pytest.raises(tart.ArtifactError, match=match):
            _build.load_artifact_kernels(str(kdir), digests)
    lib = kdir / f"row_gemm-{live}.so"
    lib.write_bytes(b"\x7fELF" + b"\0" * 60)
    with pytest.raises(tart.ArtifactError, match="checksum is missing"):
        _build.load_artifact_kernels(str(kdir), {"row_gemm": live})
    # A truncated library (its checksum the whole file's) is refused
    # before dlopen, which could die of SIGBUS on it.
    (kdir / f"row_gemm-{live}.so.sha256").write_text(
        _build.file_sha256(str(lib)) + "\n")
    lib.write_bytes(b"\x7fELF" + b"\0" * 20)
    with pytest.raises(tart.ArtifactError, match="truncated or altered"):
        _build.load_artifact_kernels(str(kdir), {"row_gemm": live})
    # Bytes that match their checksum but are no library: dlopen's error.
    (kdir / f"row_gemm-{live}.so.sha256").write_text(
        _build.file_sha256(str(lib)))
    with pytest.raises(tart.ArtifactError, match="unreadable kernel"):
        _build.load_artifact_kernels(str(kdir), {"row_gemm": live})
    assert _build.nvcc_runs == runs and not _build._pinned
    assert "row_gemm" not in _build.LOADED_FROM


# -------------------------------------------------------------- hygiene

def test_prune_keeps_the_newest_and_the_active(ref, tmp_path):
    jeng, _ = ref
    paths = []
    for i, L in enumerate((10, 11, 12)):
        eng = _port_engine(jeng, "meanpool", "greedy", artifact_keep=1)
        eng.cfg.eval.max_decode_len = L     # another ladder: another version
        paths.append(_publish(eng, tmp_path))
        os.utime(paths[-1], (1000 + i, 1000 + i))
    os.makedirs(tmp_path / ".tmp-vdead-1")
    assert tart.prune_artifacts(str(tmp_path), keep=2,
                                active=paths[0]) == [
        str(tmp_path / ".tmp-vdead-1")]
    assert tart.prune_artifacts(str(tmp_path), keep=1,
                                active=paths[0]) == [paths[1]]
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (paths[0], paths[2]))
    # Booting the old version under artifact_keep = 1 keeps it (active)
    # and drops nothing else it may not; booting the newest drops it.
    _boot(paths[0])
    assert os.path.isdir(paths[0]) and os.path.isdir(paths[2])
    _boot(paths[2])
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths[2])]


# ------------------------------------------------------- elastic fleets

def test_autoscaler_soak_booting_from_the_artifact_loses_nothing(tmp_path):
    """The burst-then-quiet soak of ``test_torch_autoscaler`` with every
    replica booted from one artifact (the scale-up through
    ``from_artifact``): up then down, nothing lost, every caption the
    static warm fleet's, each replica naming the version."""
    auto = {"min_replicas": 1, "max_replicas": 2, "window_ticks": 2,
            "scale_up_queue_depth": 2.0, "cooldown_ticks": 3,
            "scale_down_occupancy": 0.9}
    warm = _real_engine(replicas=1, autoscale=auto)
    vdir = _publish(warm, tmp_path)
    trace = _burst_then_quiet()
    static, static_served, _ = real_soak(warm, None, n_replicas=1,
                                         trace=trace)
    booted = _boot(vdir)
    booted.cfg.serving.warmup = False    # the soak's clone, as `warm`'s
    scaler = tas.Autoscaler(tas.AutoscaleConfig(**auto),
                            lambda: _boot(vdir))
    rep, served, rs = real_soak(booted, None, n_replicas=1, trace=trace,
                                autoscaler=scaler)
    assert [e[1] for e in scaler.decision_log()][:2] == ["up", "down"]
    assert rep.lost == static.lost == 0 and rep.completed
    assert {o["replica"] for o in rep.outcomes.values()} == {0, 1}
    assert set(served) == set(static_served) == set(range(20))
    for rid, toks in served.items():
        assert toks == static_served[rid], rid
    version = os.path.basename(vdir)
    assert rs.describe()["artifact_versions"] == [version, version]
