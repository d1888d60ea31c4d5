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

**The scan rollout: the split step** (``cst_rollout="scan"``, reference
``_make_split_step``).  Eager CUDA is a split layout by nature: the
device runs what the host enqueued, and the host scores between the
rollout and the update.  The rollout goes out as
``train.cst_score_chunks`` batch chunks (K, each with its own two seed
words) through the fused sampler (a stacked model's, and a chunk the
reference's sampler gate declines, through the per-step decode on the
threefry batch stream, the words its key: ``CaptionModel.sample_cache``),
then
under a greedy baseline K greedy chunks, all enqueued before the host
blocks.  Each chunk's tokens go to
pinned host memory by an asynchronous copy followed by a CUDA event, and
the host waits on that chunk's event alone, so scoring chunk c can
proceed while the device decodes chunks c+1..K (a plain ``.cpu()`` would
queue behind every later launch and wait for the whole rollout).  Only
the tokens cross to the host: the mask stays on the device for the
update.  With ``train.overlap_rewards`` the chunks feed the scorer's
``stream()`` and the greedy rows are ``submit``-ted, so a pooled scorer
works in its processes while the host fetches the next chunk; the one
wait is just before the update.  Overlap is scheduling only: on or off,
the same seed gives bitwise the same rewards, loss and parameters.

The reference's one-graph step (``io_callback`` inside one jitted step)
and its ``dispatch_latency_ms`` / ``io_callback_supported`` probes are
JAX-runtime machinery with no PyTorch form; this split step is their
counterpart in meaning.  So ``cst_split_layout="pipeline"`` (a layout
for runtimes without host callbacks) is handled as the reference handles
it where callbacks work: a warning that it is ignored, and the split
step.

**The slot rollout** (``cst_rollout="slot"``, and its bitwise twin
``"padded"``; reference ``SlotRollout`` / ``_make_slot_step``).  Sampled
and greedy-baseline rows occupy a matrix of decode slots, exit on EOS
and are harvested at tick boundaries, streaming straight to
``scorer.submit``; freed slots take the next rows.  The decode cost
follows the sum of the row lengths rather than rows x L.  Every row
draws from JAX's row-keyed threefry stream
(``decoding/core.py::row_sample_fn``): its key depends on its identity
and decode position only, and every op of the tick is row-independent
(``row_dot``, the context kernel, the ``threefry_sample`` kernel), so
the slot and padded layouts give bitwise the same tokens, rewards, loss
and parameters.  A tick reads the device once: its ``done`` flags with
the slot matrix's tokens.

**Placement** (:class:`OneDevicePlacement`; a mesh's is
``training/sharded.py::MeshPlacement``).  Both layouts ask a placement
where the rollout decodes and how the PG update runs; nothing else
differs between one device and a mesh.  A placement splits the batch's
videos into blocks, each encoded once on its own model (one block on
one device, one a data shard on a mesh).  A scan chunk decodes on the
model of the block that holds its first video and a slot rollout on the
first block's model, so a chunk's rows and seed words are the one-device
step's wherever it runs.  The update is the one-device ``_pg_update``,
or on a mesh the PG loss split over ``data`` with its gradients folded.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_torch.decoding.core import (
    CoreState,
    decode_step,
    row_sample_fn,
)
from cst_captioning_torch.models.captioner import (
    CaptionModel,
    DecodeCache,
    _repeat_cache,
    draw_seeds,
)
from cst_captioning_torch.ops.threefry import key_words
from cst_captioning_torch.ops.losses import reward_criterion
from cst_captioning_torch.parallel.collectives import token_logprobs
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


def check_cst_config(cfg) -> None:
    """Unknown layouts raise ``ValueError``, as the reference does."""
    if cfg.train.cst_split_layout not in SPLIT_LAYOUTS:
        raise ValueError(
            f"unknown cst_split_layout {cfg.train.cst_split_layout!r}")
    if cfg.train.cst_rollout not in ROLLOUTS:
        raise ValueError(f"unknown cst_rollout {cfg.train.cst_rollout!r}")


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
            suppress_unk: bool = False, category=None,
            denom=None) -> torch.Tensor:
    """The PG loss of sampled rows (reference ``_pg_update``'s
    ``loss_fn``): teacher forcing over the sampled tokens, so the graph
    from logits to parameters is differentiable (the rollout is
    decode-only).  Input = [BOS, tok_0..tok_{L-2}], PAD fed as EOS;
    ``feats`` holds the B videos and ``repeat=S`` tiles them to the B*S
    rows (row i*S + j is video i's rollout j), ``category`` (B,) their
    category ids under ``use_category``.  The log-probs are those
    of the policy the rollout drew from: the decode mask and the
    temperature applied before the log-softmax (the vocab-parallel one
    under a sharded vocab).  ``denom``: a mesh step's whole-batch mask
    sum."""
    tokens = tokens.long()
    R = tokens.shape[0]
    bos = torch.full((R, 1), BOS_ID, dtype=torch.long, device=tokens.device)
    inputs = torch.cat([bos, tokens[:, :-1]], dim=1)
    # Finished rows feed EOS, not PAD, to keep embeddings defined.
    inputs = torch.where(inputs == PAD_ID, EOS_ID, inputs)
    logits = model(feats, feat_masks, inputs, category=category, repeat=S)
    logits = CaptionModel.mask_decode_logits(logits, suppress_unk) / torch.tensor(
        temperature, dtype=torch.float32)
    tok_lp = token_logprobs(logits, tokens)
    # Post-EOS slots hold PAD, whose log-prob under the masked policy is
    # -1e30: zero them before the product with the mask.
    tok_lp = torch.where(mask > 0, tok_lp, torch.zeros_like(tok_lp))
    return reward_criterion(tok_lp, mask, advantage, denom)


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


def make_reward_scorer_for(cfg, train_ds):
    """The CIDEr-D reward scorer of ``cfg`` over ``train_ds``'s
    references (``train.reward_workers`` worker processes, 0 inline)."""
    rewarder = CiderDRewarder(
        train_ds, df_mode=cfg.data.idf_file or "corpus",
        weighted_refs=cfg.train.cst_weighted_reward)
    scorer = make_reward_scorer(rewarder, max(0, cfg.train.reward_workers))
    log.info("CST reward scorer: %s", scorer.backend)
    return scorer


class OneDevicePlacement:
    """The CST step on one device (module doc, "Placement"): one block
    of every video on ``model``, and ``_pg_update``."""

    def __init__(self, model: CaptionModel, optimizer: Optimizer):
        self.model = model
        self.optimizer = optimizer

    def blocks(self, B: int):
        """``[(model, lo, hi)]``: the video blocks the rollout encodes."""
        return [(self.model, 0, B)]

    def update(self, feats, feat_masks, S: int, tokens, mask, advantage,
               temperature: float, suppress_unk: bool, category):
        return _pg_update(self.model, self.optimizer, feats, feat_masks, S,
                          tokens, mask, advantage, temperature, suppress_unk,
                          category)


def make_cst_train_step(model: CaptionModel, optimizer: Optimizer, cfg,
                        train_ds, placement=None) -> Callable:
    """The CST step, with the XE step's signature: ``(feats, feat_masks,
    captions, weights, category, video_idx, generator, ss_prob) ->
    metrics``; ``captions``, ``weights`` and ``ss_prob`` are unused
    (sampling-based regime), ``category`` reaches the encode and the
    update (None without ``use_category``), ``generator`` gives the
    chunks' seed words.  ``train.cst_use_gt`` dispatches to the WXE step.
    ``placement``: where the rollout decodes and how the update runs
    (module doc; default :class:`OneDevicePlacement`)."""
    if cfg.train.cst_use_gt:
        log.info("cst_use_gt: dispatching CST_GT_None to the WXE step")
        return make_xe_train_step(model, optimizer)
    check_cst_config(cfg)
    _validate(cfg)
    scorer = make_reward_scorer_for(cfg, train_ds)
    rollout = cfg.train.cst_rollout
    if rollout != "scan":
        log.info("CST rollout layout: %s (slot decode runtime)", rollout)
        return _make_slot_step(model, optimizer, cfg, scorer, rollout,
                               placement)
    if cfg.train.cst_split_layout == "pipeline":
        log.warning(
            "cst_split_layout='pipeline' ignored: the split CST step is the "
            "one-graph step's counterpart here (the pipelined layout applies "
            "only to backends without host callbacks)")
    return _make_split_step(model, optimizer, cfg, scorer, placement)


def _slice_cache(cache: DecodeCache, lo: int, hi: int) -> DecodeCache:
    return DecodeCache(*(None if x is None else x[lo:hi] for x in cache))


def _video_rows(x, lo: int, hi: int, device):
    """Videos ``[lo, hi)`` of a batch leaf (a tensor, a modality dict or
    None) on ``device``."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v[lo:hi].to(device) for k, v in x.items()}
    return x[lo:hi].to(device)


def _encode_blocks(placement, feats, feat_masks, category, B: int):
    """``[(model, lo, hi, cache)]``: each of the placement's video blocks
    encoded once on its model (the decode encode is row invariant, so a
    slice of a block's cache is the slice's own encode, bit for bit)."""
    return [(m, lo, hi, m._encode(_video_rows(feats, lo, hi, m.device),
                                  _video_rows(feat_masks, lo, hi, m.device),
                                  _video_rows(category, lo, hi, m.device)))
            for m, lo, hi in placement.blocks(B)]


def _chunk_cache(encoded, lo: int, hi: int):
    """(model, cache rows ``[lo, hi)``): the model of the block holding
    video ``lo``, and the rows on its device (a chunk that straddles
    blocks takes the other blocks' rows by copy)."""
    model = next(m for m, a, b, _ in encoded if a <= lo < b)
    parts = [_slice_cache(c, max(lo, a) - a, min(hi, b) - a)
             for _, a, b, c in encoded if a < hi and lo < b]
    if len(parts) == 1:
        return model, parts[0]
    return model, DecodeCache(*(
        None if xs[0] is None else torch.cat([x.to(model.device) for x in xs])
        for xs in zip(*parts)))


def _to_host(t: torch.Tensor):
    """(host copy of ``t``, event after the copy or None): on the card an
    asynchronous copy into pinned memory and an event recorded after it
    on the stream of ``t``'s card, so the reader waits for this copy
    alone."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _host_numpy(fetched) -> np.ndarray:
    host, ev = fetched
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _make_split_step(model: CaptionModel, optimizer: Optimizer, cfg,
                     scorer, placement=None) -> Callable:
    """The split step of the module docstring, on ``placement`` (module
    doc; default :class:`OneDevicePlacement` of ``model``).  Per-call
    host wall-time phases (dispatch / sample fetch / score / greedy
    fetch / score wait / update, and the total) land in
    ``train_step.phase_ms``; the trainer folds their epoch means into
    ``history.json``."""
    if placement is None:
        placement = OneDevicePlacement(model, optimizer)
    model = placement.model
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
        # blocks.  One encode a block serves the rollout and the greedy
        # baseline.
        with torch.no_grad():
            encoded = _encode_blocks(placement, feats, feat_masks, category,
                                     B)
            chunks = [_chunk_cache(encoded, lo, hi) for lo, hi in bounds]
            rollouts, fetched = [], []
            for (m, cache), seed in zip(chunks, seeds):
                out = m.sample_cache(
                    _repeat_cache(cache, S), seed, max_len=max_len,
                    greedy=False, temperature=temperature)
                rollouts.append(out)
                fetched.append(_to_host(out.tokens))
            greedy_fetched = [
                _to_host(m.sample_cache(cache, (0, 0), max_len=max_len,
                                        greedy=True).tokens)
                for m, cache in chunks] if need_greedy else []
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
        dev = model.device
        tokens = torch.cat([r.tokens.to(dev) for r in rollouts])
        mask = torch.cat([r.mask.to(dev) for r in rollouts])
        loss, gnorm = placement.update(
            feats, feat_masks, S, tokens, mask,
            torch.from_numpy(advantage).to(dev), temperature, suppress_unk,
            category)
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
    train_step.layout = "split"
    train_step.scorer = scorer
    return train_step


# ---------------------------------------------------- slot rollout variant

class SlotRolloutState(NamedTuple):
    """The rollout's slot matrix: the decode carry, the occupants' cache
    rows and their metadata.  ``row_id`` is the occupant's global row in
    the step's rollout matrix (sampled rows first, then greedy-baseline
    rows; -1 = empty), the identity its row key derives from."""

    core: CoreState
    cache: DecodeCache        # rows lead with (S,)
    row_id: torch.Tensor      # (S,) int32
    is_sample: torch.Tensor   # (S,) bool: multinomial vs greedy row


class SlotRollout:
    """Slot-based CST rollout decode (reference ``SlotRollout``).

    ``padded=False`` ("slot"): ``n_slots`` slots (0: a quarter of the
    rows, at least 8) with admission as slots free, so the decode costs
    about the sum of the row lengths.  ``padded=True``: every row
    resident from tick 0 for exactly ceil(L / block) ticks, the same
    row-keyed math at rows x L cost, the bitwise twin.  Each tick admits
    rows into free slots (their cache rows gathered by row id, the
    slot's carry reset in place), runs ``block`` decode steps and reads
    the ``done`` flags and tokens back once.  The final slot state is
    kept per slot count and reused by the next run: leftover rows ride
    frozen (finished, step L, never harvested)."""

    def __init__(self, model: CaptionModel, *, max_len: int,
                 temperature: float, n_slots: int = 0, block: int = 1,
                 padded: bool = False):
        self.model = model
        self.L = int(max_len)
        self.T = float(temperature)
        self.n_slots_cfg = int(n_slots)
        self.block = max(1, int(block))
        self.padded = bool(padded)
        self._sst_cache: Dict[int, SlotRolloutState] = {}

    def _prepare(self, feats, feat_masks, category, repeat: int,
                 need_greedy: bool) -> DecodeCache:
        """Every rollout row's cache: the B videos encoded once, tiled to
        the B*repeat sampled rows, then the B greedy rows."""
        cache = self.model._encode(feats, feat_masks, category)
        rcache = _repeat_cache(cache, repeat)
        if not need_greedy:
            return rcache
        return DecodeCache(*(None if a is None else torch.cat([a, b])
                             for a, b in zip(rcache, cache)))

    def _init_state(self, S: int, cache_all: DecodeCache) -> SlotRolloutState:
        """Empty slots ride as finished at step L: done and frozen."""
        L = self.L
        dev = cache_all.ctx_static.device
        core = CoreState(
            state=self.model.init_state(S),
            seqs=torch.full((S, 1, L), PAD_ID, dtype=torch.int32, device=dev),
            scores=None,
            lps=None,
            finished=torch.ones((S, 1), dtype=torch.bool, device=dev),
            tokens=torch.full((S,), BOS_ID, dtype=torch.int64, device=dev),
            step=torch.full((S,), L, dtype=torch.int32, device=dev))
        cache = DecodeCache(*(
            None if x is None else x.new_zeros((S,) + tuple(x.shape[1:]))
            for x in cache_all))
        return SlotRolloutState(
            core=core, cache=cache,
            row_id=torch.full((S,), -1, dtype=torch.int32, device=dev),
            is_sample=torch.zeros((S,), dtype=torch.bool, device=dev))

    def _admit(self, sst: SlotRolloutState, cache_all: DecodeCache,
               ids: List[int], slots: List[int], n_sample: int) -> None:
        """Scatter rows ``ids`` into ``slots`` (in place): their cache
        rows, a zero carry, BOS inputs, PAD buffers, position 0."""
        dev = sst.row_id.device
        ids_t = torch.tensor(ids, dtype=torch.int64, device=dev)
        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        for leaf, rows in zip(sst.cache, cache_all):
            if leaf is not None:
                leaf[slots_t] = rows[ids_t]
        co = sst.core
        co.state.h[:, slots_t] = 0
        co.state.c[:, slots_t] = 0
        co.seqs[slots_t] = PAD_ID
        co.finished[slots_t] = False
        co.tokens[slots_t] = BOS_ID
        co.step[slots_t] = 0
        sst.row_id[slots_t] = ids_t.int()
        sst.is_sample[slots_t] = ids_t < n_sample

    def _tick(self, sst: SlotRolloutState, base) -> SlotRolloutState:
        """``block`` decode steps of the whole slot matrix."""
        model, cache = self.model, sst.cache

        def step_logits(state, tokens):
            return model.decode_logits(state, cache, tokens)

        sample_fn = row_sample_fn(base, sst.row_id, sst.is_sample)
        core = sst.core
        for _ in range(self.block):
            core = decode_step(step_logits, core, mode="sample",
                               temperature=self.T, sample_fn=sample_fn)
        return sst._replace(core=core)

    def resolve_slots(self, n_rows: int) -> int:
        if self.padded:
            return n_rows
        if self.n_slots_cfg > 0:
            return min(self.n_slots_cfg, n_rows)
        # A quarter of the rows (>= 8): enough churn headroom that freed
        # slots refill while stragglers run.
        return max(1, min(n_rows, max(8, -(-n_rows // 4))))

    @torch.no_grad()
    def run(self, feats, feat_masks, category, key, *, repeat: int,
            need_greedy: bool, on_harvest: Optional[Callable] = None):
        """Decode ``B*repeat`` sampled rows (+ B greedy rows) through the
        slot matrix, row keys derived from ``key`` (two 32-bit words, a
        JAX key's ``key_data``).  ``on_harvest(row_ids, tokens)`` fires at
        every harvest with the rows that exited.  Returns ``(tokens (N,
        L) int32 numpy, stats)``; rows ``[0, B*repeat)`` are the rollout,
        the tail the greedy baseline."""
        B = next(iter(feats.values())).shape[0]
        n_sample = B * repeat
        N = n_sample + (B if need_greedy else 0)
        L, block = self.L, self.block
        S = self.resolve_slots(N)
        base = key_words(key)
        cache_all = self._prepare(feats, feat_masks, category, repeat,
                                  need_greedy)
        sst = self._sst_cache.get(S)
        if sst is None:
            sst = self._init_state(S, cache_all)
        pending = list(range(N))
        free = list(range(S))
        occupied: Dict[int, int] = {}
        admit_tick: Dict[int, int] = {}
        out = np.full((N, L), PAD_ID, np.int32)
        ticks = row_steps = 0
        min_ticks = -(-L // block)  # padded layout: the full-L cost
        while pending or occupied:
            n = min(len(free), len(pending))
            if n:
                ids = pending[:n]
                del pending[:n]
                slots = [free.pop() for _ in range(n)]
                self._admit(sst, cache_all, ids, slots, n_sample)
                for s, r in zip(slots, ids):
                    occupied[s] = r
                    admit_tick[s] = ticks
            sst = self._tick(sst, base)
            ticks += 1
            if self.padded and ticks < min_ticks:
                continue  # the padded twin: every row pays the full L steps
            core = sst.core
            done = core.finished.all(dim=-1) | (core.step >= L)
            # The tick's one device read: done flags beside the tokens.
            host = torch.cat([done[:, None].int(), core.seqs[:, 0, :]],
                             dim=1).cpu().numpy()
            done_slots = [s for s in occupied if host[s, 0]]
            if not done_slots:
                continue
            h_ids, h_toks = [], []
            for s in done_slots:
                r = occupied.pop(s)
                free.append(s)
                out[r] = host[s, 1:]
                row_steps += min((ticks - admit_tick.pop(s)) * block, L)
                h_ids.append(r)
                h_toks.append(out[r])
            if on_harvest is not None:
                on_harvest(h_ids, np.stack(h_toks))
        self._sst_cache[S] = sst
        lengths = (out != PAD_ID).sum(axis=1)
        stats = {
            "rollout_ticks": ticks,
            "rollout_decode_steps": ticks * block,
            "rollout_steps_per_row": round(row_steps / max(1, N), 3),
            "rollout_mean_len": round(float(lengths.mean()), 3),
            "rollout_slots": S,
            "rollout_rows": N,
        }
        return out, stats


def _trim_len(tokens_np: np.ndarray, max_len: int) -> int:
    """Time-axis bucket for the PG update: every column past the longest
    harvested row is PAD with mask 0 (zero loss, zero gradient), so the
    update runs over the next power of two from 8 that holds the longest
    row and its end, capped at ``max_len``.  Both layouts trim the same
    token matrix."""
    longest = int((tokens_np != PAD_ID).sum(axis=1).max())
    t = 8
    while t < longest + 1:
        t *= 2
    return min(t, max_len)


def _make_slot_step(model: CaptionModel, optimizer: Optimizer, cfg, scorer,
                    layout: str, placement=None) -> Callable:
    """CST step whose rollout runs through :class:`SlotRollout`
    (``layout`` "slot" or its bitwise twin "padded"; reference
    ``_make_slot_step``): the slot loop with harvested rows streamed to
    ``scorer.submit``, one reward wait, one PG update over the trimmed
    tokens.  Rewards pair back to rows by row id, not harvest order.
    The rollout's key is the step's two seed words (``draw_seeds``).
    ``train_step.rollout_stats`` holds the last rollout's stats and the
    update's trim length; ``phase_ms`` its ``dispatch_ms``,
    ``score_wait_ms`` and ``update_ms``.  ``placement`` (module doc;
    default :class:`OneDevicePlacement` of ``model``): the rollout
    decodes on its ``model`` (on a mesh data shard 0's replica, whose
    row keys give the one-device tokens) and the update runs through
    it."""
    if placement is None:
        placement = OneDevicePlacement(model, optimizer)
    model = placement.model
    S, baseline_kind = _validate(cfg)
    temperature = cfg.train.sample_temperature
    max_len = cfg.data.max_seq_len
    need_greedy = baseline_kind == "greedy"
    gt_base = scorer.gt_consensus() if baseline_kind == "gt_consensus" else None
    suppress_unk = model.decode_suppress_unk
    rollout = SlotRollout(
        model, max_len=max_len, temperature=temperature,
        n_slots=max(0, cfg.train.cst_slot_count),
        block=max(1, cfg.train.cst_slot_block_steps),
        padded=layout == "padded")
    clock = PhaseClock(tags={"layout": layout})
    phase_ms: Dict[str, float] = {}
    last_stats: Dict[str, float] = {}

    def train_step(feats, feat_masks, captions, weights, category,
                   video_idx, generator, ss_prob=0.0):
        clock.start()
        vid = video_idx.cpu().numpy()
        n_sample = vid.shape[0] * S
        key = draw_seeds(generator, 1)[0]
        pending: list = []

        def on_harvest(row_ids, tokens):
            # Score freshly exited rows while the slot loop decodes on.
            row_ids = np.asarray(row_ids)
            samp = row_ids < n_sample
            for sel, videos in ((samp, row_ids[samp] // S),
                                (~samp, row_ids[~samp] - n_sample)):
                if sel.any():
                    pending.append((row_ids[sel], scorer.submit(
                        vid[videos], tokens[sel])))

        tokens_all, stats = rollout.run(
            feats, feat_masks, category, key, repeat=S,
            need_greedy=need_greedy, on_harvest=on_harvest)
        last_stats.clear()
        last_stats.update(stats)
        clock.lap("dispatch_ms")

        scores_all = np.zeros((tokens_all.shape[0],), np.float32)
        for rows, p in pending:
            scores_all[rows] = p.wait()
        rewards = scores_all[:n_sample]
        greedy_scores = scores_all[n_sample:] if need_greedy else None
        clock.lap("score_wait_ms")
        baseline = _baseline_from(
            rewards, greedy_scores, S, baseline_kind,
            gt_rows=None if gt_base is None else gt_base[vid])
        advantage = rewards - baseline
        Lt = _trim_len(tokens_all[:n_sample], max_len)
        last_stats["update_trim_len"] = Lt
        dev = model.device
        tokens = torch.from_numpy(tokens_all[:n_sample, :Lt]).to(dev)
        loss, gnorm = placement.update(
            feats, feat_masks, S, tokens, (tokens != PAD_ID).float(),
            torch.from_numpy(advantage).to(dev), temperature, suppress_unk,
            category)
        clock.lap("update_ms")
        clock.commit(phase_ms)
        return {
            "loss": loss,
            "grad_norm": gnorm,
            "reward": float(rewards.mean()),
            "baseline": float(baseline.mean()),
            "advantage": float(advantage.mean()),
            "rollout_steps_per_row": float(stats["rollout_steps_per_row"]),
        }

    train_step.phase_ms = phase_ms
    train_step.layout = f"slot:{layout}"
    train_step.scorer = scorer
    train_step.rollout_stats = last_stats
    return train_step
