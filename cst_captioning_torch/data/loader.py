"""Fixed-shape batch iterator with device prefetch (the port's copy of
the JAX package's ``data/loader.py``).

* Every batch has identical shapes: the final partial batch wraps
  around the video list when ``drop_last=False``.
* Frames are uniformly subsampled / zero-padded to ``max_frames`` with
  a validity mask (:func:`subsample_frames`, shared with serving); a
  dataset whose modalities are all packed (``features_batch``) hands
  over a whole batch in one gather instead.
* The per-epoch order and caption picks come from the reference's
  numpy stream (``RandomState(seed + 1000003 * epoch)``), so both
  packages yield the same batches.
* :func:`prefetch_to_device` assembles host batches in a daemon thread
  and copies them to the device from pinned memory, so the transfer
  overlaps the previous step's compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, NamedTuple

import numpy as np
import torch

from cst_captioning_torch.data.datasets import CaptionDataset


class Batch(NamedTuple):
    """One fixed-shape training batch: numpy on the host, torch tensors
    after :func:`prefetch_to_device`.

    B = videos per batch, S = seq_per_img, F = max_frames, L = caption
    slots (max_words + 2 for BOS/EOS).
    """

    feats: Dict[str, np.ndarray]        # m -> (B, F, D_m) float32 (a packed
                                        # float16 store stays float16)
    feat_masks: Dict[str, np.ndarray]   # m -> (B, F) float32
    captions: np.ndarray                # (B, S, L) int32
    weights: np.ndarray                 # (B, S) float32 consensus weights
    category: np.ndarray                # (B,) int32
    video_idx: np.ndarray               # (B,) int32 dataset indices
    video_ids: List[str]                # host-side ids (never copied)


def subsample_frames(frames: np.ndarray, max_frames: int) -> np.ndarray:
    """Uniform temporal subsample to at most ``max_frames`` rows."""
    if frames.shape[0] <= max_frames:
        return frames
    idx = np.linspace(0, frames.shape[0] - 1, max_frames).round().astype(int)
    return frames[idx]


class BatchIterator:
    """Epoch-based iterator over a :class:`CaptionDataset`."""

    def __init__(
        self,
        dataset: CaptionDataset,
        batch_size: int,
        seq_per_img: int,
        max_frames: int,
        *,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"bad shard {shard_id}/{num_shards}")
        self.ds = dataset
        self.batch_size = batch_size
        self.seq_per_img = seq_per_img
        self.max_frames = max_frames
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        # Process sharding (parallel/distributed.py): a contiguous-stride
        # split of the video index space, the reference's.
        self._indices = np.arange(shard_id, len(dataset), num_shards)
        self.caption_len = int(dataset.captions(0).shape[1])

    def num_batches(self) -> int:
        n = len(self._indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """Deterministic per-epoch stream (seed + epoch -> permutation)."""
        order = self._indices.copy()
        rng = np.random.RandomState(self.seed + 1000003 * epoch)
        if self.shuffle:
            rng.shuffle(order)
        n = len(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, limit, self.batch_size):
            chunk = order[start: start + self.batch_size]
            if len(chunk) < self.batch_size:
                # Wrap-around pad (tiling when the dataset is smaller
                # than a batch) keeps the shapes static.
                pad = np.resize(order, self.batch_size - len(chunk))
                chunk = np.concatenate([chunk, pad])
            yield self._assemble(chunk, rng)

    def _assemble(self, idxs: np.ndarray, rng: np.random.RandomState) -> Batch:
        B, S, F, L = (len(idxs), self.seq_per_img, self.max_frames,
                      self.caption_len)
        # Packed fast path (data/packed.py): one vectorized gather per
        # modality instead of B per-video reads; the features keep the
        # stored dtype.
        batched = getattr(self.ds, "features_batch", lambda *_: None)(idxs, F)
        if batched is not None:
            feats, fmasks = batched
        else:
            feats = {m: np.zeros((B, F, d), np.float32)
                     for m, d in self.ds.feature_dims.items()}
            fmasks = {m: np.zeros((B, F), np.float32)
                      for m in self.ds.feature_dims}
        captions = np.zeros((B, S, L), np.int32)
        weights = np.ones((B, S), np.float32)
        category = np.zeros((B,), np.int32)
        for b, i in enumerate(idxs):
            i = int(i)
            if batched is None:
                for m, fr in self.ds.features(i).items():
                    fr = subsample_frames(fr, F)
                    feats[m][b, : fr.shape[0]] = fr
                    fmasks[m][b, : fr.shape[0]] = 1.0
            caps = self.ds.captions(i)
            w = self.ds.caption_weights(i)
            n = caps.shape[0]
            # seq_per_img captions per video: without replacement when
            # possible, with replacement otherwise (reference behaviour).
            pick = (rng.choice(n, S, replace=False) if n >= S
                    else rng.choice(n, S, replace=True))
            captions[b] = caps[pick]
            weights[b] = w[pick]
            category[b] = self.ds.category(i)
        return Batch(
            feats=feats,
            feat_masks=fmasks,
            captions=captions,
            weights=weights,
            category=category,
            video_idx=idxs.astype(np.int32),
            video_ids=[self.ds.video_id(int(i)) for i in idxs],
        )


def to_device(batch: Batch, device: torch.device) -> Batch:
    """The batch's arrays as tensors on ``device`` (``video_ids`` stays
    on the host).  CUDA copies go from pinned memory, asynchronously on
    the current stream."""
    cuda = device.type == "cuda"

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if cuda:
            t = t.pin_memory()
        return t.to(device, non_blocking=cuda)

    return Batch(
        feats={m: put(a) for m, a in batch.feats.items()},
        feat_masks={m: put(a) for m, a in batch.feat_masks.items()},
        captions=put(batch.captions),
        weights=put(batch.weights),
        category=put(batch.category),
        video_idx=put(batch.video_idx),
        video_ids=batch.video_ids,
    )


PREFETCH_DEPTH = 2   # batches staged ahead of the consumer


def prefetch_to_device(batches: Iterator[Batch], device) -> Iterator[Batch]:
    """Stage batches onto ``device`` ahead of consumption.

    A daemon thread assembles host batches and copies their arrays to the
    device (:func:`to_device`), at most ``PREFETCH_DEPTH`` ahead.  An
    exception in the thread is handed to the consumer and re-raised
    there; a consumer that stops early releases the thread, drains the
    queue and joins it."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
    END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not _put(to_device(b, device)):
                    return
            _put(END)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            _put(e)

    thread = threading.Thread(target=worker, daemon=True,
                              name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=10.0)
