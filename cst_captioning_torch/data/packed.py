"""Packed contiguous feature storage (the port's copy of the JAX
package's ``data/packed.py``).

One contiguous array per modality instead of one h5 dataset per video:

* layout: ``<dir>/<modality>.npy`` shaped (V, F, D), every video
  uniformly subsampled / zero-padded to F frames at pack time, plus
  ``<dir>/<modality>.meta.json`` ({"modality", "num_videos", "frames",
  "dim", "dtype", "frame_counts", "video_ids"});
* reads are fancy-indexed gathers from ``np.load(mmap_mode="r")``:
  assembling a (B, F, D) batch is one vectorized copy out of the page
  cache;
* ``dtype="float16"`` halves the bytes on disk and in flight.  Such a
  batch keeps the stored dtype up to the model, which casts it to its
  compute dtype (``CaptionModel._encode``).

``H5Dataset`` accepts a packed directory anywhere a feature h5 path is
expected (``data.feature_files``), and ``BatchIterator`` takes the
batched gather when every modality is packed
(``H5Dataset.features_batch``).  ``tools/pack_features.py`` converts
per-video h5s; :func:`pack_dataset` packs any ``CaptionDataset``.  The
files are byte for byte the JAX package's.

Remote stores: any fsspec URL (a path holding ``://``: ``gs://bucket/
dir``, ``s3://...``, ``memory://...``) is read as a packed directory,
as the reference reads it.  The meta json comes through fsspec and row
gathers become ranged reads against the remote ``.npy`` (the header
parsed once; one exact read a row, or one ``cat_ranges`` call a batch),
with no download of the whole file.  ``fsspec`` is imported only for
such a path; where it is not installed (the GPU host has none) the path
raises an ``ImportError`` naming it, never a read of a local path of
that name.  Remote reads are host work on the CPU; packing writes a
local directory only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _is_remote(path: str) -> bool:
    return "://" in path


def _url_to_fs(url: str):
    """``(filesystem, root)`` of an fsspec URL, importing fsspec here."""
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            f"the packed store {url!r} is an fsspec URL: reading it needs "
            "the fsspec package, which is not installed") from e
    fs, root = fsspec.core.url_to_fs(url)
    return fs, root.rstrip("/")


def _meta_path(directory: str, modality: str) -> str:
    return os.path.join(directory, f"{modality}.meta.json")


def _arr_path(directory: str, modality: str) -> str:
    return os.path.join(directory, f"{modality}.npy")


def pack_modality(
    directory: str,
    modality: str,
    video_ids: List[str],
    frames_iter,
    max_frames: int,
    dim: int,
    dtype: str = "float32",
) -> str:
    """Write one modality's packed array.

    ``frames_iter`` yields one (F_i, D) array per video in ``video_ids``
    order; each is uniformly subsampled / zero-padded to ``max_frames``.
    Streams straight into the memmap: peak memory is one video."""
    from cst_captioning_torch.data.loader import subsample_frames

    if _is_remote(directory):
        raise ValueError(
            f"cannot pack into {directory!r}: packing writes a local "
            "directory; copy it to the store afterwards")
    os.makedirs(directory, exist_ok=True)
    path = _arr_path(directory, modality)
    V = len(video_ids)
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.dtype(dtype), shape=(V, max_frames, dim))
    counts = np.zeros((V,), np.int32)
    for i, frames in enumerate(frames_iter):
        fr = subsample_frames(np.asarray(frames), max_frames)
        out[i, : fr.shape[0]] = fr
        out[i, fr.shape[0]:] = 0
        counts[i] = fr.shape[0]
    out.flush()
    del out
    with open(_meta_path(directory, modality), "w") as f:
        json.dump({
            "modality": modality,
            "num_videos": V,
            "frames": max_frames,
            "dim": dim,
            "dtype": dtype,
            "frame_counts": counts.tolist(),
            "video_ids": video_ids,
        }, f)
    return path


def pack_dataset(
    ds,
    directory: str,
    max_frames: int,
    modalities: Sequence[str] = (),
    dtype: str = "float32",
) -> Dict[str, str]:
    """Pack every (or the named) modalities of a ``CaptionDataset``."""
    modalities = list(modalities) or list(ds.feature_dims)
    vids = [ds.video_id(i) for i in range(len(ds))]
    return {m: pack_modality(directory, m, vids,
                             (ds.features(i)[m] for i in range(len(ds))),
                             max_frames, int(ds.feature_dims[m]), dtype=dtype)
            for m in modalities}


class _RemoteNpyRows:
    """Row-gather view of a remote ``.npy`` through fsspec (reference
    ``_RemoteNpyRows``): the header is parsed once, then ``[i]`` and
    ``[array of i]`` are ranged reads of the rows' bytes.  It supports
    the access patterns ``PackedSource`` uses."""

    def __init__(self, fs, path: str):
        self._fs = fs
        self._path = path
        with fs.open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            if fortran:
                raise ValueError(f"{path}: fortran-order npy unsupported")
            self._offset = f.tell()
        self.shape = shape
        self.dtype = dtype
        self._row_bytes = int(np.prod(shape[1:])) * dtype.itemsize
        # No block cache: training gathers are shuffled row reads, and a
        # readahead block would fetch megabytes for each row.
        self._f = fs.open(path, "rb", cache_type="none")
        self._has_cat_ranges = hasattr(fs, "cat_ranges")

    def _span(self, i: int) -> Tuple[int, int]:
        start = self._offset + int(i) * self._row_bytes
        return start, start + self._row_bytes

    def _row(self, buf: bytes) -> np.ndarray:
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.shape[1:])

    def _read_row(self, i: int) -> np.ndarray:
        self._f.seek(self._span(i)[0])
        return self._row(self._f.read(self._row_bytes))

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self._read_row(key)
        idxs = np.asarray(key)
        if not self._has_cat_ranges:
            return np.stack([self._read_row(i) for i in idxs])
        spans = [self._span(i) for i in idxs]
        # on_error="raise": the default hands back exception objects in
        # the list.
        bufs = self._fs.cat_ranges([self._path] * len(spans),
                                   [a for a, _ in spans],
                                   [b for _, b in spans], on_error="raise")
        return np.stack([self._row(b) for b in bufs])


class PackedSource:
    """Reader for one packed modality: memmap-backed for a local
    directory (reads hit the OS page cache), ranged fsspec reads for a
    URL."""

    def __init__(self, directory: str, modality: str):
        if _is_remote(directory):
            fs, root = _url_to_fs(directory)
            with fs.open(f"{root}/{modality}.meta.json") as f:
                self.meta = json.load(f)
            self._arr = _RemoteNpyRows(fs, f"{root}/{modality}.npy")
        else:
            with open(_meta_path(directory, modality)) as f:
                self.meta = json.load(f)
            self._arr = np.load(_arr_path(directory, modality),
                                mmap_mode="r")
        self.modality = modality
        self.frames = int(self.meta["frames"])
        self.dim = int(self.meta["dim"])
        self.frame_counts = np.asarray(self.meta["frame_counts"], np.int32)
        self.video_ids = list(self.meta["video_ids"])
        want = (len(self.video_ids), self.frames, self.dim)
        if self._arr.shape != want:
            raise ValueError(f"{_arr_path(directory, modality)}: shape "
                             f"{self._arr.shape}, its meta says {want}")

    def get(self, idx: int) -> np.ndarray:
        """(F_i, D) float32, trimmed to the video's true frame count
        (the ``CaptionDataset.features`` contract)."""
        n = int(self.frame_counts[idx])
        return np.asarray(self._arr[idx][:n], np.float32)

    def get_batch(self, idxs: np.ndarray,
                  max_frames: int) -> Tuple[np.ndarray, np.ndarray]:
        """One vectorized gather -> ((B, F, D) in the stored dtype, (B, F)
        float32 mask).  Requires ``max_frames`` equal to the packed frame
        count: a silent leading-frames crop would diverge from the
        per-video path's uniform subsample."""
        if max_frames != self.frames:
            raise ValueError(
                f"loader max_frames={max_frames} != packed frames="
                f"{self.frames} for modality {self.modality!r} — repack "
                "at the training max_frames")
        feats = self._arr[idxs]
        counts = np.minimum(self.frame_counts[idxs], max_frames)
        mask = (np.arange(max_frames)[None, :]
                < counts[:, None]).astype(np.float32)
        return feats, mask


def is_packed_dir(path: str) -> bool:
    """Whether ``path`` (a local directory or an fsspec URL) holds at
    least one ``*.meta.json`` packed modality (``H5Dataset``'s routing
    test)."""
    if _is_remote(path):
        fs, root = _url_to_fs(path)
        try:
            names = fs.ls(root, detail=False)
        except FileNotFoundError:
            # Only a missing directory is "not packed"; other errors
            # propagate rather than route the path to the h5 reader.
            return False
        return any(str(n).endswith(".meta.json") for n in names)
    if not os.path.isdir(path):
        return False
    return any(n.endswith(".meta.json") for n in os.listdir(path))
