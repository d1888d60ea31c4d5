"""Child-process side of the CST reward pool (port of the JAX package's
``metrics/reward_worker.py``).

``training/rewards.py::RewardPool`` starts its workers with the
``forkserver`` method: the fork server is a clean process (created by
spawn, so it inherits none of the trainer's threads or its CUDA
context), and every worker forks from it.  Forking straight from the
trainer would copy a process that holds a CUDA context and the
allocator's and data loader's threads; a CUDA context does not survive
a fork, and a lock held by another thread at fork time never unlocks.

Each worker imports this module at pool start, so its import chain
stays numpy-only: it must never import ``torch``.  Workers score with
pure numpy/python and never touch the card.

State protocol: :func:`pool_init` receives one pickled payload at pool
start (cooked reference sets + the corpus n-gram document-frequency
table — the big shared tables cross the process boundary once);
:func:`pool_score` then scores ``(video_idx, token_ids)`` row shards
against it.  Scores are bit-identical to the parent's serial python
scorer: the same :func:`~cst_captioning_torch.metrics.cider.
ciderd_score_rows` loop, the same deterministic ``cook_refs_vec``
vectors.
"""

from __future__ import annotations

import pickle
from typing import List, Sequence

import numpy as np

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_torch.metrics.cider import (
    ciderd_score_rows,
    cook_refs_vec,
    precook,
)


def ids_until_end(row: Sequence[int]) -> List[int]:
    """Candidate tokens: everything before the first PAD/EOS, skipping BOS
    (sampled sequences never contain BOS, but encoded refs do)."""
    out = []
    for t in row:
        t = int(t)
        if t in (PAD_ID, EOS_ID):
            break
        if t == BOS_ID:
            continue
        out.append(t)
    return out


# Per-worker scoring state, installed once by pool_init at pool start.
_WORKER_STATE: dict = {}


def pool_init(payload: bytes) -> None:
    global _WORKER_STATE
    # The payload is the parent pool's own pickle of its rewarder tables.
    _WORKER_STATE = pickle.loads(payload)
    # Per-video tf-idf reference vectors are cooked lazily in the worker
    # (first batch touching the video) and memoized — cook_refs_vec is
    # deterministic, so worker-cooked vectors are bit-identical to the
    # parent's serial ones.
    _WORKER_STATE["vec_cache"] = {}


def pool_score(task) -> np.ndarray:
    vids, token_ids = task
    st = _WORKER_STATE
    cache = st["vec_cache"]
    refs, df, lrl = st["cooked_refs"], st["doc_freq"], st["log_ref_len"]
    weights = st["ref_weights"]
    vec_rows, w_rows, cands = [], None if weights is None else [], []
    for b in range(token_ids.shape[0]):
        v = int(vids[b])
        if v not in cache:
            cache[v] = cook_refs_vec(refs[v], df, lrl)
        vec_rows.append(cache[v])
        if w_rows is not None:
            w_rows.append(weights[v])
        cands.append(precook(ids_until_end(token_ids[b])))
    return ciderd_score_rows(cands, vec_rows, df, lrl, use_d=st["use_d"],
                             ref_weights_rows=w_rows)
