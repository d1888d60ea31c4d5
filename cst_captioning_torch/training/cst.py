"""CST / SCST training step: consensus-based self-critical REINFORCE
(port of the JAX package's ``training/cst.py``).

Per step: multinomial rollouts (S per video), in-loop CIDEr-D scoring of
them against each video's references, a baseline, advantage = reward -
baseline, and a policy-gradient (PG) update on the rollout log-probs.
Baselines (``train.cst_baseline``):

* ``greedy`` — the greedy decode's reward (CST_MS_Greedy / classic SCST);
* ``scb`` — the paper's self-consensus baseline: for rollout j the
  leave-one-out mean reward of the video's other S - 1 rollouts;
* ``gt_consensus`` — the video's mean leave-one-out GT-caption CIDEr-D;
* ``none`` — raw REINFORCE.

``train.cst_use_gt`` (CST_GT_None: the GT captions weighted by their
consensus, no rollout) is the WXE regime and takes the WXE step.

**The one layout: the split step** (reference ``_make_split_step``, for
``cst_split_layout`` "auto" and "chunked").  Eager CUDA is a split
layout by nature: the device runs what the host enqueued, and the host
scores between the rollout and the update.  The rollout goes out as
``train.cst_score_chunks`` batch chunks (K, each with its own two seed
words), then under a greedy baseline K greedy chunks, all enqueued
before the host blocks.  Each chunk's tokens go to pinned host memory
by an asynchronous copy followed by a CUDA event, and the host waits on
that chunk's event alone, so scoring chunk c can proceed while the
device decodes chunks c+1..K (a plain ``.cpu()`` would queue behind
every later launch and wait for the whole rollout).  Only the tokens
cross to the host: the mask stays on the device for the update.  With ``train.overlap_rewards`` the
chunks feed the scorer's ``stream()`` and the greedy rows are
``submit``-ted, so a pooled scorer works in its processes while the
host fetches the next chunk; the one wait is just before the update.
Overlap is scheduling only: on or off, the same seed gives bitwise the
same rewards, loss and parameters.

The reference's one-graph step (``io_callback`` inside one jitted step)
and its ``dispatch_latency_ms`` / ``io_callback_supported`` probes are
JAX-runtime machinery with no PyTorch form; this split step is their
counterpart in meaning.  Still refused, naming ROADMAP.md Queue 1 item
1's remaining part: ``cst_rollout`` "padded" / "slot" (the slot
rollout needs the decode core's ``mode="sample"``) and
``cst_split_layout="pipeline"`` (a layout for high-latency runtimes).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict

import numpy as np
import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_torch.models.captioner import (
    CaptionModel,
    DecodeCache,
    _repeat_cache,
    draw_seeds,
    not_ported,
)
from cst_captioning_torch.ops.losses import reward_criterion
from cst_captioning_torch.training.rewards import (
    CiderDRewarder,
    make_reward_scorer,
)
from cst_captioning_torch.training.steps import (
    Optimizer,
    PhaseClock,
    make_xe_train_step,
)

log = logging.getLogger("cst_captioning_torch.cst")

SPLIT_LAYOUTS = ("auto", "pipeline", "chunked")
ROLLOUTS = ("scan", "padded", "slot")
_REMAINING = "Queue 1, item 1 (CST: the slot rollout and the pipeline layout)"


def check_cst_config(cfg) -> None:
    """Refuse what the port does not run: unknown layouts raise
    ``ValueError`` (as the reference does), the unported ones
    ``NotImplementedError`` naming their ROADMAP item."""
    layout = cfg.train.cst_split_layout
    if layout not in SPLIT_LAYOUTS:
        raise ValueError(f"unknown cst_split_layout {layout!r}")
    rollout = cfg.train.cst_rollout
    if rollout not in ROLLOUTS:
        raise ValueError(f"unknown cst_rollout {rollout!r}")
    if rollout != "scan":
        raise not_ported(f"cst_rollout={rollout!r}", _REMAINING)
    if layout == "pipeline":
        raise not_ported("cst_split_layout='pipeline'", _REMAINING)


def _validate(cfg):
    S = max(1, cfg.train.cst_num_samples)
    baseline_kind = cfg.train.cst_baseline
    if baseline_kind not in ("greedy", "scb", "none", "gt_consensus"):
        raise ValueError(f"unknown cst_baseline {baseline_kind!r}")
    if baseline_kind == "scb" and S < 2:
        raise ValueError(
            "cst_baseline='scb' needs cst_num_samples >= 2 (the leave-one-"
            "out consensus baseline is undefined for a single rollout)")
    return S, baseline_kind


def _baseline_from(rewards: np.ndarray, greedy_scores, S: int,
                   baseline_kind: str, gt_rows=None) -> np.ndarray:
    """Host-side baseline: the greedy decode's reward (SCST), the
    leave-one-out rollout mean (SCB), the per-video GT-caption consensus
    score (``gt_rows`` (B,) gathered from ``CiderDRewarder.gt_consensus``)
    or zeros.  ``rewards`` is the (B*S,) rollout reward vector in
    repeated row order; ``greedy_scores`` the (B,) greedy rewards."""
    if baseline_kind == "greedy":
        return np.repeat(np.asarray(greedy_scores, np.float32), S, axis=0)
    if baseline_kind == "scb":
        r = rewards.reshape(-1, S)
        loo = (r.sum(axis=1, keepdims=True) - r) / (S - 1)
        return loo.reshape(-1).astype(np.float32)
    if baseline_kind == "gt_consensus":
        return np.repeat(np.asarray(gt_rows, np.float32), S, axis=0)
    return np.zeros_like(rewards)


def _chunk_count(requested: int, B: int) -> int:
    """Largest divisor of ``B`` that is <= ``requested`` (>= 1)."""
    k = max(1, min(requested, B))
    while B % k:
        k -= 1
    return k


def pg_loss(model: CaptionModel, feats, feat_masks, S: int,
            tokens: torch.Tensor, mask: torch.Tensor,
            advantage: torch.Tensor, temperature: float,
            suppress_unk: bool = False, category=None) -> torch.Tensor:
    """The PG loss of sampled rows (reference ``_pg_update``'s
    ``loss_fn``): teacher forcing over the sampled tokens, so the graph
    from logits to parameters is differentiable (the rollout is
    decode-only).  Input = [BOS, tok_0..tok_{L-2}], PAD fed as EOS;
    ``feats`` holds the B videos and ``repeat=S`` tiles them to the B*S
    rows (row i*S + j is video i's rollout j), ``category`` (B,) their
    category ids under ``use_category``.  The log-probs are those
    of the policy the rollout drew from: the decode mask and the
    temperature applied before the log-softmax."""
    tokens = tokens.long()
    R = tokens.shape[0]
    bos = torch.full((R, 1), BOS_ID, dtype=torch.long, device=tokens.device)
    inputs = torch.cat([bos, tokens[:, :-1]], dim=1)
    # Finished rows feed EOS, not PAD, to keep embeddings defined.
    inputs = torch.where(inputs == PAD_ID, EOS_ID, inputs)
    logits = model(feats, feat_masks, inputs, category=category, repeat=S)
    logits = CaptionModel.mask_decode_logits(logits, suppress_unk) / torch.tensor(
        temperature, dtype=torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    tok_lp = torch.gather(logp, -1, tokens[..., None])[..., 0]
    # Post-EOS slots hold PAD, whose log-prob under the masked policy is
    # -1e30: zero them before the product with the mask.
    tok_lp = torch.where(mask > 0, tok_lp, torch.zeros_like(tok_lp))
    return reward_criterion(tok_lp, mask, advantage)


def _pg_update(model: CaptionModel, optimizer: Optimizer, feats, feat_masks,
               S: int, tokens, mask, advantage, temperature: float,
               suppress_unk: bool = False, category=None):
    """PG loss, gradients, global norm and one optimizer step (reference
    ``_pg_update``).  Returns ``(loss, pre-clip grad norm)`` as device
    scalars."""
    names, params = zip(*model.named_parameters())
    loss = pg_loss(model, feats, feat_masks, S, tokens, mask, advantage,
                   temperature, suppress_unk, category)
    grads = torch.autograd.grad(loss, params)
    gnorm = optimizer.step(dict(zip(names, grads)))
    return loss.detach(), gnorm


def make_cst_train_step(model: CaptionModel, optimizer: Optimizer, cfg,
                        train_ds) -> Callable:
    """The CST step, with the XE step's signature: ``(feats, feat_masks,
    captions, weights, category, video_idx, generator, ss_prob) ->
    metrics``; ``captions``, ``weights`` and ``ss_prob`` are unused
    (sampling-based regime), ``category`` reaches the encode and the
    update (None without ``use_category``), ``generator`` gives the
    chunks' seed words.  ``train.cst_use_gt`` dispatches to the WXE step."""
    if cfg.train.cst_use_gt:
        log.info("cst_use_gt: dispatching CST_GT_None to the WXE step")
        return make_xe_train_step(model, optimizer)
    check_cst_config(cfg)
    _validate(cfg)
    rewarder = CiderDRewarder(
        train_ds, df_mode=cfg.data.idf_file or "corpus",
        weighted_refs=cfg.train.cst_weighted_reward)
    scorer = make_reward_scorer(rewarder, max(0, cfg.train.reward_workers))
    log.info("CST reward scorer: %s", scorer.backend)
    return _make_split_step(model, optimizer, cfg, scorer)


def _slice_cache(cache: DecodeCache, lo: int, hi: int) -> DecodeCache:
    return DecodeCache(*(None if x is None else x[lo:hi] for x in cache))


def _to_host(t: torch.Tensor):
    """(host copy of ``t``, event after the copy or None): on the card an
    asynchronous copy into pinned memory and an event recorded after it,
    so the reader waits for this copy alone."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _host_numpy(fetched) -> np.ndarray:
    host, ev = fetched
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _make_split_step(model: CaptionModel, optimizer: Optimizer, cfg,
                     scorer) -> Callable:
    """The split step of the module docstring.  Per-call host wall-time
    phases (dispatch / sample fetch / score / greedy fetch / score wait
    / update, and the total) land in ``train_step.phase_ms``; the
    trainer folds their epoch means into ``history.json``."""
    S, baseline_kind = _validate(cfg)
    temperature = cfg.train.sample_temperature
    max_len = cfg.data.max_seq_len
    need_greedy = baseline_kind == "greedy"
    overlap = bool(cfg.train.overlap_rewards)
    gt_base = scorer.gt_consensus() if baseline_kind == "gt_consensus" else None
    k_requested = max(1, cfg.train.cst_score_chunks)
    suppress_unk = model.decode_suppress_unk
    clock = PhaseClock(tags={"layout": "split"})
    phase_ms: Dict[str, float] = {}

    def train_step(feats, feat_masks, captions, weights, category,
                   video_idx, generator, ss_prob=0.0):
        clock.start()
        # Host reads of the batch's video ids and the chunks' seed words:
        # they wait for the previous step's update, whose device work
        # this step's rollout follows on the stream in any case.
        vid = video_idx.cpu().numpy()
        B = vid.shape[0]
        K = _chunk_count(k_requested, B)
        step = B // K
        bounds = [(c * step, (c + 1) * step) for c in range(K)]
        seeds = draw_seeds(generator, K)

        # Phase 1: enqueue everything the scorer consumes before the host
        # blocks.  One encode serves the rollout and the greedy baseline
        # (the decode encode is row invariant, so a slice of it is the
        # slice's own encode, bit for bit).
        with torch.no_grad():
            cache = model._encode(feats, feat_masks, category)
            rollouts, fetched = [], []
            for (lo, hi), seed in zip(bounds, seeds):
                out = model.sample_cache(
                    _repeat_cache(_slice_cache(cache, lo, hi), S), seed,
                    max_len=max_len, greedy=False, temperature=temperature)
                rollouts.append(out)
                fetched.append(_to_host(out.tokens))
            greedy_fetched = [
                _to_host(model.sample_cache(
                    _slice_cache(cache, lo, hi), (0, 0), max_len=max_len,
                    greedy=True).tokens)
                for lo, hi in bounds] if need_greedy else []
        clock.lap("dispatch_ms")

        # Phase 2: host scoring, chunk by chunk as each reaches the host.
        stream = scorer.stream() if overlap else None
        reward_parts = []
        for (lo, hi), f in zip(bounds, fetched):
            vid_r = np.repeat(vid[lo:hi], S, axis=0)
            tokens_np = _host_numpy(f)
            clock.lap("sample_fetch_ms")
            if stream is not None:
                stream.feed(vid_r, tokens_np)
            else:
                reward_parts.append(
                    scorer.score_ids(vid_r, tokens_np).astype(np.float32))
            clock.lap("score_ms")

        greedy_pending = greedy_scores = None
        if need_greedy:
            greedy_np = []
            for f in greedy_fetched:
                greedy_np.append(_host_numpy(f))
                clock.lap("greedy_fetch_ms")
            if overlap:
                greedy_pending = [scorer.submit(vid[lo:hi], toks)
                                  for (lo, hi), toks in zip(bounds, greedy_np)]
            else:
                greedy_scores = np.concatenate([
                    scorer.score_ids(vid[lo:hi], toks).astype(np.float32)
                    for (lo, hi), toks in zip(bounds, greedy_np)])
            clock.lap("score_ms")

        rewards = (stream.finish() if stream is not None
                   else np.concatenate(reward_parts))
        if greedy_pending is not None:
            greedy_scores = np.concatenate(
                [p.wait() for p in greedy_pending]).astype(np.float32)
        clock.lap("score_wait_ms")
        baseline = _baseline_from(
            rewards, greedy_scores, S, baseline_kind,
            gt_rows=None if gt_base is None else gt_base[vid])
        advantage = rewards - baseline

        # Phase 3: one PG update over the whole batch; the chunks
        # concatenate back to the repeated row order.
        tokens = torch.cat([r.tokens for r in rollouts])
        mask = torch.cat([r.mask for r in rollouts])
        loss, gnorm = _pg_update(
            model, optimizer, feats, feat_masks, S, tokens, mask,
            torch.from_numpy(advantage).to(tokens.device), temperature,
            suppress_unk, category)
        clock.lap("update_ms")
        clock.commit(phase_ms)
        return {
            "loss": loss,
            "grad_norm": gnorm,
            "reward": float(rewards.mean()),
            "baseline": float(baseline.mean()),
            "advantage": float(advantage.mean()),
        }

    train_step.phase_ms = phase_ms
    train_step.scorer = scorer
    return train_step
