"""Serving artifacts: the versioned deploy unit of an elastic fleet (port
of the JAX package's ``serving/artifact.py``).

The reference ships a replica's compiled XLA tick ladder, so that a boot
compiles nothing.  The port's one compilation is ``nvcc``
(``ops/_build.py`` builds each kernel library at first use), so its
artifact ships the built ``sm_90a`` libraries that the engine's serving
paths launch, and a boot runs no ``nvcc``:

```
<root>/<artifact_version>/        (published atomically: tmp + rename)
  manifest.json   schema, fingerprint (params_tag / mesh_shape / preset /
                  package version / serving_dtype), environment (torch
                  and CUDA versions, platform, card and compute
                  capability), every slot-loop variant and admission
                  encode with its shape signature, the int8w scale
                  hashes, the kernel digests, the full Config
  params.pt       the model's state dict, and infos.json: a params-only
  infos.json      checkpoint of training/checkpoint.py, so cli/test.py
                  --checkpoint and InferenceEngine(checkpoint=) load it
  vocab.json      the engine's vocabulary
  kernels/        <name>-<digest>.so, one per InferenceEngine.
                  serving_kernels() name, byte for byte what nvcc wrote,
                  and <name>-<digest>.so.sha256, its checksum (none for
                  an engine on the CPU)
```

**Build** (:func:`build_artifact`, ``cli/build_artifact.py``): the
variants are enumerated by the slot loop's own ladder code
(``SlotDecoder.aot_variant_keys`` / ``aot_encode_buckets``, the
reference's key strings) and signed by the shapes and dtypes they run at
(``SlotDecoder.aot_signatures``, the counterpart of the reference's hash
of the lowered program).  The version is ``"v"`` + a sha256 over the
manifest without ``artifact_version``, ``config`` and ``built_utc``, so
rebuilding an unchanged engine finds its version published and writes
nothing (``rebuilt: False``).

**Load** (:func:`load_engine`, ``InferenceEngine.from_artifact``): every
manifest field is compared with the live one (schema, ``env.*``,
``fingerprint.version`` / ``mesh_shape`` / ``preset``,
``serving_dtype``, ``scale_hashes``, ``kernels.<name>`` against the live
sources' digest, the kernel set, ``variants`` and ``encode_variants``)
before any kernel library is loaded or any launch runs; a divergence
raises :class:`ArtifactMismatchError` naming every divergent field at
once, never a rebuild.  Then the libraries load from ``kernels/`` (no
``nvcc``, no fallback to ``_kernels_build/``: a missing, truncated or
altered one raises :class:`ArtifactError`, its bytes checked against
their checksum before ``dlopen``), and the ladder is walked once
(``InferenceEngine.warmup``), so the first request pays no first-launch
cost (the context kernel fills its tanh table at its first launch on a
card).  The engine keeps the build's ``params_tag`` (one logical model:
tier-1 and tier-2 entries hit across replicas) and reports the version
in ``fingerprint()``.  Loading also prunes versions beyond
``serving.artifact_keep``; the active one is never pruned
(:func:`prune_artifacts`).

Parity (docs/PARITY.md r14, "artifact boot cannot change tokens"): the
booted engine runs the same libraries on the same params, so its tokens
and scores are bitwise a warm engine's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops._build import ArtifactError

_log = logging.getLogger("cst_captioning_torch.serving")

ARTIFACT_SCHEMA_VERSION = 1
MANIFEST_NAME = "manifest.json"
KERNELS_DIR = "kernels"
_VOCAB_NAME = "vocab.json"
_TMP_PREFIX = ".tmp-"

# The environment fields compared one by one at load.
_ENV_FIELDS = ("torch_version", "cuda_version", "platform", "device_kind",
               "compute_capability")
# The fingerprint fields a manifest records (the reference's block).
_FP_FIELDS = ("params_tag", "mesh_shape", "preset", "version",
              "serving_dtype")
MANIFEST_KEYS = ("schema", "fingerprint", "env", "variants",
                 "encode_variants", "serving_dtype", "scale_hashes",
                 "artifact_version", "config", "built_utc", "kernels")

class ArtifactMismatchError(ArtifactError):
    """The refusal: the manifest does not match the live environment,
    sources or engine.  ``mismatches`` holds every divergent field as
    ``(field, artifact_value, live_value)``."""

    def __init__(self, mismatches: List[Tuple[str, Any, Any]]):
        self.mismatches = list(mismatches)
        detail = "; ".join(f"{f}: artifact={a!r} live={b!r}"
                           for f, a, b in self.mismatches)
        super().__init__(
            f"artifact refused — {len(self.mismatches)} manifest field(s) "
            f"mismatch the live environment: {detail}")

    @property
    def fields(self) -> List[str]:
        return [f for f, _, _ in self.mismatches]


def environment_block(device=None) -> Dict[str, str]:
    """The live-environment half of the refusal contract, for ``device``
    (``cuda`` unless the caller passes ``"cpu"``)."""
    from cst_captioning_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        kind = torch.cuda.get_device_name(idx)
        cc = "%d.%d" % torch.cuda.get_device_capability(idx)
    else:
        kind, cc = "cpu", ""
    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda or "",
            "platform": dev.type, "device_kind": kind,
            "compute_capability": cc}


def artifact_bytes(path: str) -> int:
    """On-disk bytes of one artifact version."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def _fingerprint_block(engine) -> Dict[str, Any]:
    fp = engine.fingerprint()
    return {k: fp[k] for k in _FP_FIELDS}


def _kernel_digests(engine) -> Dict[str, str]:
    """``{name: digest}`` of the libraries the engine's serving paths
    launch; none on the CPU, where the wrappers run their plain
    versions."""
    if engine.device.type != "cuda":
        return {}
    return {n: _build.kernel_digest(n) for n in engine.serving_kernels()}


def _signatures(engine) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The live ladder's signatures; a ladder engine's slot decoder
    (built only to enumerate them) is dropped again."""
    had = engine._slot_decoder is not None
    out = engine.slot_decoder().aot_signatures()
    if not had and not engine.cfg.serving.continuous:
        engine._slot_decoder = None
    return out


# ------------------------------------------------------------------ build

def build_artifact(engine, out_root: str) -> Dict[str, Any]:
    """Publish ``engine`` as a versioned artifact under ``out_root`` (see
    module doc), building its kernel libraries first where this process
    has none.  Atomic: written into a ``.tmp-*`` sibling and renamed, so
    a crashed build leaves nothing a loader would trust.  Returns the
    path, version, whether it was written, seconds, bytes and counts."""
    from cst_captioning_torch.ops import quant
    from cst_captioning_torch.training.checkpoint import save_params

    t0 = time.perf_counter()
    variants, encode = _signatures(engine)
    kernels = _kernel_digests(engine)
    core = {
        "schema": ARTIFACT_SCHEMA_VERSION,
        "fingerprint": _fingerprint_block(engine),
        "env": environment_block(engine.device),
        "variants": variants,
        "encode_variants": encode,
        "serving_dtype": engine.serving_dtype,
        "scale_hashes": quant.scale_hashes(engine.model.full_state_dict()),
        "kernels": kernels,
    }
    version = "v" + hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()).hexdigest()[:12]
    final = os.path.join(out_root, version)

    def summary(rebuilt: bool) -> Dict[str, Any]:
        return {"path": final, "artifact_version": version,
                "rebuilt": rebuilt, "build_s": time.perf_counter() - t0,
                "artifact_bytes": artifact_bytes(final),
                "variants": len(variants), "encode_variants": len(encode),
                "kernels": sorted(kernels)}

    os.makedirs(out_root, exist_ok=True)
    if os.path.exists(os.path.join(final, MANIFEST_NAME)):
        _log.info("artifact %s already published — reusing", final)
        return summary(False)
    tmp = os.path.join(out_root, f"{_TMP_PREFIX}{version}-{os.getpid()}")
    try:
        os.makedirs(os.path.join(tmp, KERNELS_DIR))
        _build.build(list(kernels))
        for name, digest in kernels.items():
            # ctypes loads by path: ship nvcc's bytes, never a rebuild,
            # with their checksum (checked before a boot opens them).
            lib = os.path.join(tmp, KERNELS_DIR, f"{name}-{digest}.so")
            shutil.copyfile(_build.library_path(name), lib)
            with open(lib + ".sha256", "w") as f:
                f.write(_build.file_sha256(lib) + "\n")
        save_params(tmp, engine.model, extra={"artifact_version": version,
                                              "preset": engine.cfg.name})
        engine.vocab.save(os.path.join(tmp, _VOCAB_NAME))
        manifest = dict(core, artifact_version=version,
                        config=engine.cfg.to_dict(),
                        built_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                time.gmtime()))
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _log.info("artifact %s published: %d tick + %d encode variants, "
              "kernels %s, %.1fs", final, len(variants), len(encode),
              sorted(kernels), time.perf_counter() - t0)
    return summary(True)


# ------------------------------------------------------------------- load

def _resolve_version_dir(path: str) -> str:
    """``path`` is a version directory (it holds a manifest) or an
    artifact root, whose newest published version is taken."""
    if os.path.exists(os.path.join(path, MANIFEST_NAME)):
        return path
    if not os.path.isdir(path):
        raise ArtifactError(f"no artifact at {path!r}")
    versions = [os.path.join(path, d) for d in os.listdir(path)
                if not d.startswith(_TMP_PREFIX)
                and os.path.exists(os.path.join(path, d, MANIFEST_NAME))]
    if not versions:
        raise ArtifactError(
            f"{path!r} holds no published artifact version (a crashed "
            "build leaves only .tmp-* directories, which are never loaded)")
    return max(versions, key=os.path.getmtime)


def load_manifest(version_dir: str) -> Dict[str, Any]:
    p = os.path.join(version_dir, MANIFEST_NAME)
    try:
        with open(p) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError(f"unreadable manifest {p!r}: {e}") from e
    if not isinstance(man, dict):
        raise ArtifactError(f"manifest {p!r} is not a JSON object")
    for key in MANIFEST_KEYS:
        if key not in man:
            raise ArtifactError(f"manifest {p!r} missing key {key!r}")
    return man


def _drift(field: str, built: Dict[str, Any], live: Dict[str, Any]
           ) -> List[Tuple[str, Any, Any]]:
    """``[(field, built entries, live entries)]`` of the keys whose
    values differ or exist on one side only; empty when equal."""
    keys = sorted(k for k in set(built) | set(live)
                  if built.get(k) != live.get(k))
    if not keys:
        return []
    return [(field, {k: built[k] for k in keys if k in built},
             {k: live[k] for k in keys if k in live})]


def _environment_mismatches(man: Dict[str, Any], device
                            ) -> List[Tuple[str, Any, Any]]:
    """Schema, environment, package version and kernel digests: what is
    checked without an engine."""
    from cst_captioning_torch import __version__

    mm: List[Tuple[str, Any, Any]] = []
    if man["schema"] != ARTIFACT_SCHEMA_VERSION:
        mm.append(("schema", man["schema"], ARTIFACT_SCHEMA_VERSION))
    env = environment_block(device)
    for f in _ENV_FIELDS:
        if man["env"].get(f) != env[f]:
            mm.append((f"env.{f}", man["env"].get(f), env[f]))
    if man["fingerprint"].get("version") != __version__:
        mm.append(("fingerprint.version", man["fingerprint"].get("version"),
                   __version__))
    for name, digest in sorted(man["kernels"].items()):
        live = (_build.kernel_digest(name) if name in _build.SOURCES
                else None)
        if digest != live:
            mm.append((f"kernels.{name}", digest, live))
    return mm


def load_engine(path: str, engine_cls=None, replica_id=None, device=None,
                devices=None):
    """Boot an ``InferenceEngine`` from an artifact (see module doc):
    refuse on any manifest field that differs from the live one, then
    load the kernel libraries from the artifact, restore the params and
    walk the ladder.  ``device``: ``cuda`` unless the caller passes
    ``"cpu"``; ``devices``: a model-sharded engine's device list (its
    mesh shape must be the manifest's)."""
    from cst_captioning_torch.config import Config
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.device import resolve_device
    from cst_captioning_torch.ops import quant
    from cst_captioning_torch.training.checkpoint import load_params_file

    if engine_cls is None:
        from cst_captioning_torch.serving.engine import InferenceEngine

        engine_cls = InferenceEngine
    t0 = time.perf_counter()
    dev = resolve_device(device)
    vdir = _resolve_version_dir(path)
    man = load_manifest(vdir)
    mm = _environment_mismatches(man, dev)
    try:
        cfg = Config.from_dict(man["config"])
        vocab = Vocabulary.load(os.path.join(vdir, _VOCAB_NAME))
        params = load_params_file(vdir)
    except (OSError, KeyError, TypeError, ValueError, RuntimeError, EOFError,
            pickle.UnpicklingError) as e:
        raise ArtifactError(f"unreadable artifact {vdir!r}: {e}") from e
    # The boot walks the ladder itself, after the refusal checks.
    cfg.serving.warmup = False
    try:
        engine = engine_cls(cfg, params=params, vocab=vocab, device=dev,
                            devices=devices)
    except (KeyError, ValueError) as e:
        raise ArtifactError(f"artifact {vdir!r} does not build an engine: "
                            f"{e}") from e
    fp = man["fingerprint"]
    # One logical model: every replica booted from the artifact keeps
    # the build's tag, so tier-1 / tier-2 entries hit across them.
    engine.params_tag = fp.get("params_tag", engine.params_tag)
    engine.replica_id = replica_id
    live_fp = engine.fingerprint()
    for f in ("mesh_shape", "preset"):
        if fp.get(f) != live_fp[f]:
            mm.append((f"fingerprint.{f}", fp.get(f), live_fp[f]))
    if man["serving_dtype"] != engine.serving_dtype:
        mm.append(("serving_dtype", man["serving_dtype"],
                   engine.serving_dtype))
    mm += _drift("scale_hashes", man["scale_hashes"],
                 quant.scale_hashes(engine.model.full_state_dict()))
    live_kernels = sorted(_kernel_digests(engine))
    if sorted(man["kernels"]) != live_kernels:
        mm.append(("kernels", sorted(man["kernels"]), live_kernels))
    variants, encode = _signatures(engine)
    mm += _drift("variants", man["variants"], variants)
    mm += _drift("encode_variants", man["encode_variants"], encode)
    if mm:
        raise ArtifactMismatchError(mm)
    kernels = _build.load_artifact_kernels(
        os.path.join(vdir, KERNELS_DIR), man["kernels"])
    engine.artifact_version = man["artifact_version"]
    engine.warmup()
    # A booted engine is warm; its clones (replicas, scale-ups) warm
    # themselves at birth as a warm engine's do.
    engine.cfg.serving.warmup = True
    prune_artifacts(os.path.dirname(os.path.abspath(vdir)),
                    keep=int(cfg.serving.artifact_keep), active=vdir)
    _log.info("artifact boot %s: kernels %s from %s, no nvcc run, %.1fs",
              man["artifact_version"], sorted(kernels),
              os.path.join(vdir, KERNELS_DIR), time.perf_counter() - t0)
    return engine


# --------------------------------------------------------------- hygiene

def prune_artifacts(root: str, keep: int = 2,
                    active: Optional[str] = None) -> List[str]:
    """Drop artifact versions beyond the ``keep`` newest (by mtime) and
    any ``.tmp-*`` leftovers of crashed builds.  The ``active`` version
    is never removed, whatever its age.  Returns the removed paths."""
    keep = max(1, int(keep))
    if not os.path.isdir(root):
        return []
    active_real = os.path.realpath(active) if active else None
    removed: List[str] = []
    versions: List[str] = []
    for d in sorted(os.listdir(root)):
        p = os.path.join(root, d)
        if not os.path.isdir(p):
            continue
        if d.startswith(_TMP_PREFIX):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
        elif os.path.exists(os.path.join(p, MANIFEST_NAME)):
            versions.append(p)
    versions.sort(key=os.path.getmtime, reverse=True)
    for p in versions[keep:]:
        if active_real is not None and os.path.realpath(p) == active_real:
            continue
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
        _log.info("pruned stale artifact version %s", p)
    return removed
