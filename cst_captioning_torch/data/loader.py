"""Per-video frame preprocessing shared by serving and (later) the batch
loader: the port's copy of the JAX package's ``data/loader.py::
subsample_frames``."""

from __future__ import annotations

import numpy as np


def subsample_frames(frames: np.ndarray, max_frames: int) -> np.ndarray:
    """Uniform temporal subsample to at most ``max_frames`` rows."""
    if frames.shape[0] <= max_frames:
        return frames
    idx = np.linspace(0, frames.shape[0] - 1, max_frames).round().astype(int)
    return frames[idx]
