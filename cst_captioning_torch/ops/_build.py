"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
Nothing is built at import time: the first launch of a kernel builds it
(or :func:`build` builds several at once, one ``nvcc`` per source, all
started together).  Libraries land in ``_kernels_build/`` inside the
package, named by a digest of the sources and flags, so an edited
source is never served by a stale library.  The directory is listed in
``.gitignore``.

A serving artifact (``serving/artifact.py``) ships the built libraries
as ``kernels/<name>-<digest>.so``.  :func:`load_artifact_kernels` loads
them from there, each digest equal to the live one, and from then on
:func:`load` serves those libraries and refuses any other name: a
replica booted from an artifact runs no ``nvcc`` and reads nothing from
``_kernels_build/``.  :data:`nvcc_runs` counts the compilers started in
the process and :data:`LOADED_FROM` records each library's path, so a
boot can show both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels_build")
SOURCES = {
    "lstm_beam": "lstm_beam.cu",
    "lstm_sample": "lstm_sample.cu",
    "lstm_recurrence": "lstm_recurrence.cu",
    "attlstm_recurrence": "attlstm_recurrence.cu",
    "context_attention": "context_attention.cu",
    "context_attention_bwd": "context_attention_bwd.cu",
    "row_gemm": "row_gemm.cu",
    "threefry_sample": "threefry_sample.cu",
}
HEADERS = ("decode_common.cuh", "attention_common.cuh", "tc_common.cuh",
           "attention_tc.cuh", "decode_tc.cuh", "context_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# The path each loaded library came from, and the libraries an artifact
# pinned (name -> path); once any is pinned, `load` builds nothing.
LOADED_FROM: Dict[str, str] = {}
_pinned: Dict[str, str] = {}
# nvcc processes started in this process (one per source built).
nvcc_runs = 0
# Compiler output (ptxas register / shared-memory report) per kernel,
# filled by the build that produced the library in this process.
BUILD_LOGS: Dict[str, str] = {}


_count_lock = threading.Lock()


class ArtifactError(ValueError):
    """A malformed or unreadable serving artifact: a missing manifest
    key, a missing, truncated or mismatched kernel library."""


def count_launch(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to a wrapper's launch counter (``fn.launches`` or
    ``fn.quant_launches``).  Under a lock: replica workers launch from
    several threads, and a bare ``+=`` can lose an update."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + n)


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from csrc/ at first use"
    )


def kernel_digest(name: str) -> str:
    """The digest of kernel ``name``'s sources and flags: the name of its
    library, and what an artifact's manifest records."""
    h = hashlib.sha1()
    for f in (SOURCES[name],) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode())
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{kernel_digest(name)}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that have no library
    yet, in parallel.  Returns ``{name: compiler log}`` for what was
    built; raises with the log if any compile fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    if _pinned:
        raise ArtifactError(
            f"kernels {todo} would need nvcc, but this process serves the "
            f"kernels of a serving artifact ({sorted(_pinned)})")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    global nvcc_runs
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
        nvcc_runs += 1
    logs, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        logs[n] = log
        if p.returncode != 0:
            failed.append(n)
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    BUILD_LOGS.update(logs)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def _open(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.cst_error_string.argtypes = [ctypes.c_int]
    lib.cst_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    LOADED_FROM[name] = path
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``: built first if needed or,
    after :func:`load_artifact_kernels`, the artifact's copy (a name the
    artifact does not ship raises :class:`ArtifactError`)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _pinned:
                if name not in _pinned:
                    raise ArtifactError(
                        f"kernel {name!r} is not in the serving artifact "
                        f"this process booted from ({sorted(_pinned)})")
                return _open(name, _pinned[name])
            build([name])
            lib = _open(name, library_path(name))
        return lib


def file_sha256(path: str) -> str:
    """sha256 of a file's bytes (an artifact's library checksum)."""
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def load_artifact_kernels(kernels_dir: str,
                          digests: Dict[str, str]) -> Dict[str, str]:
    """Load the libraries an artifact's manifest names (``{name:
    digest}``) from ``kernels_dir/<name>-<digest>.so`` and pin them, so
    :func:`load` serves them and nothing else.  Each digest must equal
    the live sources' (:func:`kernel_digest`), and each file's bytes the
    checksum beside it (``<library>.sha256``, written by the build):
    ``dlopen`` of a truncated library can kill the process with SIGBUS
    instead of failing, so the bytes are checked first.  A library
    already loaded in this process is kept; it was built from the same
    sources.  No ``nvcc`` runs and ``_kernels_build/`` is never read: an
    unknown name, a digest mismatch or a missing, altered or unreadable
    file raises :class:`ArtifactError`.  Returns ``{name: path}``."""
    paths = {}
    for name, digest in sorted(digests.items()):
        if name not in SOURCES:
            raise ArtifactError(f"artifact kernel {name!r} is not one of "
                                f"{sorted(SOURCES)}")
        live = kernel_digest(name)
        if digest != live:
            raise ArtifactError(
                f"artifact kernel {name} was built from digest {digest}, "
                f"the live sources give {live}")
        path = os.path.join(kernels_dir, f"{name}-{digest}.so")
        try:
            with open(path + ".sha256") as f:
                want = f.read().strip()
            got = file_sha256(path)
        except OSError as e:
            raise ArtifactError(
                f"artifact kernel library {path} or its checksum is "
                f"missing or unreadable: {e}") from e
        if got != want:
            raise ArtifactError(
                f"artifact kernel library {path} is truncated or altered: "
                f"sha256 {got}, its checksum says {want}")
        paths[name] = path
    with _lock:
        for name, path in paths.items():
            if name not in _libs:
                try:
                    _open(name, path)
                except OSError as e:
                    raise ArtifactError(
                        f"unreadable kernel library {path}: {e}") from e
        _pinned.update(paths)
    return paths




def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch was refused (``err`` is a cudaError_t)."""
    if err != 0:
        msg = lib.cst_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
