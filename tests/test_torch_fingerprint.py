"""The engine fingerprint's mesh and the serving artifact's mesh
refusal (``InferenceEngine._mesh_shape_str``, ``serving/artifact.py``),
in ``tests/test_torch_artifact.py``'s style.

``fingerprint()["mesh_shape"]`` is the engine's real mesh (``"1x2"`` for
a two-way model-sharded engine, ``"1x1"`` otherwise), as the JAX
engine's; an artifact published from a sharded engine boots only onto
an engine of the same mesh, and a manifest whose mesh differs is refused
naming ``fingerprint.mesh_shape``, as JAX ``artifact.py`` refuses it.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.ops import _build
from cst_captioning_torch.serving import artifact as tart
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_tpu.config import get_preset as jpreset
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine

WORDS = [f"w{i}" for i in range(36)]


def _cfg(get, shards):
    c = get("synthetic_smoke")
    sv = c.serving
    sv.continuous, sv.warmup, sv.decode_mode = True, False, "greedy"
    sv.num_slots, sv.slot_bank_min = 4, 2
    sv.model_shards = shards
    return c


def _engine(shards):
    return InferenceEngine(_cfg(get_preset, shards), random_init=True,
                           vocab=Vocabulary(WORDS),
                           devices=["cpu"] * max(shards, 1))


@pytest.mark.parametrize("shards", [1, 2])
def test_fingerprint_mesh_is_the_engines_as_in_jax(shards):
    eng = _engine(shards)
    jeng = JaxEngine(_cfg(jpreset, shards), random_init=True,
                     devices=jax.devices()[:shards] if shards > 1 else None)
    assert eng.fingerprint()["mesh_shape"] == jeng._mesh_shape_str()
    assert eng._mesh_shape_str() == ("1x2" if shards > 1 else "1x1")


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    eng = _engine(2)
    out = tart.build_artifact(eng, str(tmp_path_factory.mktemp("art")))
    assert out["rebuilt"]
    return eng, out["path"]


def _tokens(eng, n=4):
    reqs = [eng.prepare({"features": {"resnet": np.full((3, 64), i + 1.0,
                                                        np.float32)}})
            for i in range(n)]
    return [r.tokens for r in eng.decode_prepared(reqs, store=False)]


def test_sharded_artifact_boots_on_its_mesh(published):
    eng, path = published
    man = tart.load_manifest(path)
    assert man["fingerprint"]["mesh_shape"] == "1x2"
    before = _build.nvcc_runs
    booted = InferenceEngine.from_artifact(path, device="cpu",
                                           devices=["cpu"] * 2)
    assert _build.nvcc_runs == before
    assert booted.fingerprint()["mesh_shape"] == "1x2"
    assert booted.model.vshards is not None
    assert _tokens(booted) == _tokens(eng)


def test_sharded_artifact_refuses_another_mesh(published, tmp_path):
    _, path = published
    # One device cannot build the manifest's two-way engine.
    with pytest.raises(tart.ArtifactError, match="does not build an engine"):
        InferenceEngine.from_artifact(path, device="cpu")
    bad = str(tmp_path / os.path.basename(path))
    shutil.copytree(path, bad)
    man = tart.load_manifest(bad)
    man["fingerprint"]["mesh_shape"] = "1x1"
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(tart.ArtifactMismatchError) as e:
        InferenceEngine.from_artifact(bad, device="cpu", devices=["cpu"] * 2)
    assert e.value.fields == ["fingerprint.mesh_shape"]
    assert ("fingerprint.mesh_shape", "1x1", "1x2") in e.value.mismatches
