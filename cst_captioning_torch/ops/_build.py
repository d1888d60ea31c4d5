"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
Nothing is built at import time: the first launch of a kernel builds it
(or :func:`build` builds several at once, one ``nvcc`` per source, all
started together).  Libraries land in ``_kernels_build/`` inside the
package, named by a digest of the sources and flags, so an edited
source is never served by a stale library.  The directory is listed in
``.gitignore``.
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
# Compiler output (ptxas register / shared-memory report) per kernel,
# filled by the build that produced the library in this process.
BUILD_LOGS: Dict[str, str] = {}


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


def _digest(name: str) -> str:
    h = hashlib.sha1()
    for f in (SOURCES[name],) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode())
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that have no library
    yet, in parallel.  Returns ``{name: compiler log}`` for what was
    built; raises with the log if any compile fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.cst_error_string.argtypes = [ctypes.c_int]
            lib.cst_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch was refused (``err`` is a cudaError_t)."""
    if err != 0:
        msg = lib.cst_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
