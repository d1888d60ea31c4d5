"""Native (C++) CIDEr-D scorer and its ctypes binding (port of the JAX
package's ``native/``).

``ciderd.cpp`` is the CST reward scorer's fast path.  :func:`build_ciderd`
compiles it with ``g++`` at first use into the package's
``_kernels_build/`` (listed in ``.gitignore``), named by a digest of the
source and the flags, so an edited source is never served by a stale
library.  Concurrent builds are safe: a process-wide lock, and each
build writes a process-unique temporary file renamed into place
atomically, so no process ever loads a half-written library.

:class:`NativeCiderD` computes the math of the Python scorer in
``training/rewards.py::CiderDRewarder``; it keeps the reference vectors in
float32, so a score can differ from the Python one in its last bit.
``tests/test_torch_rewards.py`` holds it bitwise to the JAX package's
native scorer.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import math
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger("cst_captioning_torch.native")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ciderd.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_kernels_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_BUILD_LOCK = threading.Lock()
_LIB_HANDLE: Optional[ctypes.CDLL] = None

MAX_TOKEN_ID = 1 << 15  # packing bound in ciderd.cpp


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> str:
    h = hashlib.sha1()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ciderd-{h.hexdigest()[:16]}.so")


def build_ciderd() -> str:
    """Compile ciderd.cpp with g++ unless its library exists; returns
    the library's path."""
    lib = library_path()
    with _BUILD_LOCK:
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=120)
            os.replace(tmp, lib)
        except (OSError, subprocess.SubprocessError) as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            detail = getattr(e, "stderr", "") or str(e)
            raise NativeUnavailable(f"g++ build failed: {detail}") from e
        log.info("built %s", lib)
        return lib


def _load() -> ctypes.CDLL:
    global _LIB_HANDLE
    if _LIB_HANDLE is not None:
        return _LIB_HANDLE
    lib = ctypes.CDLL(build_ciderd())
    P, I = ctypes.c_void_p, ctypes.c_int
    IP, FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    lib.ciderd_new.argtypes = []
    lib.ciderd_new.restype = P
    lib.ciderd_free.argtypes = [P]
    lib.ciderd_free.restype = None
    lib.ciderd_add_video.argtypes = [P, IP, IP, I]
    lib.ciderd_add_video.restype = None
    lib.ciderd_set_video_weights.argtypes = [P, I, FP, I]
    lib.ciderd_set_video_weights.restype = None
    lib.ciderd_finalize.argtypes = [P]
    lib.ciderd_finalize.restype = None
    lib.ciderd_set_df.argtypes = [P, IP, IP, FP, I]
    lib.ciderd_set_df.restype = None
    lib.ciderd_finalize_with_df.argtypes = [P, ctypes.c_double]
    lib.ciderd_finalize_with_df.restype = None
    lib.ciderd_num_videos.argtypes = [P]
    lib.ciderd_num_videos.restype = I
    lib.ciderd_score.argtypes = [P, IP, IP, I, I, FP]
    lib.ciderd_score.restype = I
    lib.ciderd_gt_consensus.argtypes = [P, FP]
    lib.ciderd_gt_consensus.restype = None
    _LIB_HANDLE = lib
    return lib


def _int_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeCiderD:
    """C++ CIDEr-D scorer over token-id sequences.

    ``refs_per_video``: list (dataset order) of lists of id sequences
    (word ids only — no BOS/EOS/PAD).  ``df`` optional {ngram tuple: raw
    df} with ``log_ref_len`` for idf-table mode; corpus mode otherwise.
    ``ref_weights``: optional per-video (num_refs,) consensus weights
    (None entries = uniform) — the paper's weighted consensus reward.
    """

    def __init__(
        self,
        refs_per_video: List[List[Sequence[int]]],
        df=None,
        log_ref_len: Optional[float] = None,
        vocab_size: Optional[int] = None,
        ref_weights: Optional[List[Optional[np.ndarray]]] = None,
    ):
        # The packing bound must hold for anything a candidate can contain
        # (sampled rollouts range over the whole vocab), not just the refs.
        if vocab_size is not None and vocab_size > MAX_TOKEN_ID:
            raise NativeUnavailable(
                f"vocab_size {vocab_size} exceeds the native packing bound "
                f"({MAX_TOKEN_ID})")
        if ref_weights is not None and len(ref_weights) != len(refs_per_video):
            raise ValueError(
                f"ref_weights has {len(ref_weights)} entries for "
                f"{len(refs_per_video)} videos")
        lib = _load()
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.ciderd_new())
        for i, refs in enumerate(refs_per_video):
            if any(t >= MAX_TOKEN_ID for r in refs for t in r):
                raise NativeUnavailable(
                    f"token id >= {MAX_TOKEN_ID} exceeds the native packing "
                    "bound")
            flat = np.asarray([t for r in refs for t in r], dtype=np.int32)
            lens = np.asarray([len(r) for r in refs], dtype=np.int32)
            if flat.size == 0:
                flat = np.zeros(1, np.int32)  # valid pointer, lens all 0
            lib.ciderd_add_video(self._handle, _int_ptr(flat), _int_ptr(lens),
                                 len(refs))
            w = None if ref_weights is None else ref_weights[i]
            if w is not None:
                w = np.ascontiguousarray(w, dtype=np.float32)
                if w.shape != (len(refs),):
                    raise ValueError(f"video {i}: {w.shape[0]} weights for "
                                     f"{len(refs)} references")
                lib.ciderd_set_video_weights(self._handle, i, _float_ptr(w),
                                             len(refs))
        if df is None:
            lib.ciderd_finalize(self._handle)
        else:
            ngrams = list(df.items())
            flat = np.asarray([t for ng, _ in ngrams for t in ng],
                              dtype=np.int32)
            lens = np.asarray([len(ng) for ng, _ in ngrams], dtype=np.int32)
            vals = np.asarray([v for _, v in ngrams], dtype=np.float32)
            if flat.size == 0:
                flat = np.zeros(1, np.int32)
            lib.ciderd_set_df(self._handle, _int_ptr(flat), _int_ptr(lens),
                              _float_ptr(vals), len(ngrams))
            if log_ref_len is None:
                log_ref_len = math.log(max(len(refs_per_video), 2))
            lib.ciderd_finalize_with_df(self._handle,
                                        ctypes.c_double(log_ref_len))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.ciderd_free(handle)

    def gt_consensus(self) -> np.ndarray:
        """(num_videos,) leave-one-out GT consensus, threaded in C++:
        the math and units of the Python ``CiderDRewarder.gt_consensus``."""
        n = self._lib.ciderd_num_videos(self._handle)
        out = np.zeros((n,), np.float32)
        self._lib.ciderd_gt_consensus(self._handle, _float_ptr(out))
        return out

    def score_ids(self, video_idx: np.ndarray,
                  token_ids: np.ndarray) -> np.ndarray:
        vidx = np.ascontiguousarray(video_idx, dtype=np.int32)
        toks = np.ascontiguousarray(token_ids, dtype=np.int32)
        B, L = toks.shape
        if vidx.shape != (B,):
            raise ValueError(f"video_idx shape {vidx.shape} for {B} rows")
        out = np.zeros((B,), np.float32)
        rc = self._lib.ciderd_score(self._handle, _int_ptr(vidx),
                                    _int_ptr(toks), B, L, _float_ptr(out))
        if rc != 0:
            n = self._lib.ciderd_num_videos(self._handle)
            raise IndexError(f"video_idx out of range [0, {n}) — rewarder "
                             "built on a different split?")
        return out
