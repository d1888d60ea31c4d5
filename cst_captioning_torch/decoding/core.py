"""The one autoregressive decode step (port of the JAX package's
``decoding/core.py``: beam, greedy and sample modes).

* :class:`DecodeState`: the per-layer ``(h, c)`` carry.
* :class:`CoreState`: the decode-loop carry over G row groups of K rows
  (beam: K = beam width; greedy and sample: K = 1): LSTM state, token
  buffers, beam scores, finished flags, next-step input tokens,
  per-group write positions and, in sample mode, the threefry key.
* :func:`decode_step`: the per-step recurrence every per-step consumer
  drives: the offline beam (``decoding/beam.py::beam_search_from_state``),
  per-step greedy and multinomial decode
  (``CaptionModel._sample_from_cache``), the continuous slot loop
  (``serving/slots.py``) and CST's slot rollout
  (``training/cst.py::SlotRollout``).  Beam mode keeps the reference's
  PAD-freeze of finished beams, parent gather, EOS/PAD finish and
  PAD->EOS feed; the row modes their draw with PAD at zero log-prob
  after the end.
* :func:`row_sample_fn`: the row-keyed noise of the slot rollout.
* :func:`greedy_pick`: the greedy decision rule, shared by
  :func:`decode_step` and the speculative round
  (``decoding/speculative.py::spec_round``).

Write positions are per-group counters (``CoreState.step``): offline
loops advance all groups together, the slot loops hold groups at
different depths in one matrix.

Selection order.  Beam top-K ranks by (value desc, flat key ``k*V + v``
asc), the order ``lax.top_k`` gives; greedy takes the lowest index of
the largest log-prob, ``jnp.argmax``'s.  ``torch.topk`` promises no
order among ties, so :func:`select_top` ranks int64 composites: an
order-preserving integer image of the float value in the high 32 bits
and the complement of the flat index in the low 32.  Composites are
unique, so one ``topk`` over them is exact, tie order included, on any
device and for any row count.

Sample mode draws from JAX's own threefry streams, replayed bit for bit
(``ops/threefry.py``): the carry's key is split each step on the host
(two Python ints, no device read) and the step's key feeds the batch
stream of ``jax.random.categorical``; :func:`row_sample_fn` keys each
row by its identity and decode position instead.  Both draws are one
``threefry_sample`` kernel launch a step on the card, which also gives
the token's log-probability.

Tensor-parallel selection (the reference's ``topk_fn`` / ``pick_fn``
hooks): under a vocab sharded over a mesh's ``model`` axis the model
hook returns ``VocabShardedLogits`` (``parallel/collectives.py``), and
:func:`make_tp_beam_topk` / :func:`make_tp_row_pick` build the hooks
that keep every shard on its own tile: per-shard top-K candidates with
GLOBAL flat keys (``k*V + v_global``), one gather of the (shards*K)
candidate table onto the lead device, and a re-top-K of the union by
(value desc, key asc), with the log-softmax normalizer folded from the
shards' (max, sum of exp) (docs/PARITY.md r15).  Without a hook,
sharded logits are gathered whole first (the gather path).
:data:`DECODE_KERNEL_CAPS` says which mesh axes each fused decode path
survives; ``models/captioner.py::model_from_config`` gates on it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_torch.ops.threefry import key_words, split, threefry_sample
from cst_captioning_torch.parallel.collectives import (
    VocabShardedLogits,
    pmax,
    psum,
)

NEG_INF = -1e30
_LOW32 = (1 << 32) - 1

# Which mesh axes each fused decode path survives (reference
# ``DECODE_KERNEL_CAPS``): "model", the vocab sharded over the mesh's
# model axis (the sampler and the beam have a sharded port,
# ``ops/shard_decode.py``); "data", a batch-sharded mesh (none has).
DECODE_KERNEL_CAPS = {
    "use_pallas_lstm": {"model": False, "data": False},
    "use_pallas_attention": {"model": False, "data": False},
    "use_pallas_sampler": {"model": True, "data": False},
    "use_pallas_beam": {"model": True, "data": False},
}


def kernel_supports(flag: str, axis: str) -> bool:
    """True when the fused path behind ``use_pallas_*`` flag ``flag``
    survives sharding over mesh ``axis``."""
    caps = DECODE_KERNEL_CAPS.get(flag)
    return bool(caps and caps.get(axis, False))


class DecodeState(NamedTuple):
    """Autoregressive decoder carry: per-layer (h, c)."""

    h: torch.Tensor  # (num_layers, B, H) compute dtype
    c: torch.Tensor  # (num_layers, B, H) float32


class CoreState(NamedTuple):
    """Carry of the decode loop over G groups of K rows (flat row axis
    ``G*K``).  ``scores`` is None in the row modes, ``lps`` None in beam
    mode or when not wanted; ``rng`` is the sample mode's threefry key
    (two 32-bit Python ints) or None."""

    state: DecodeState              # (layers, G*K, H) LSTM carry
    seqs: torch.Tensor              # (G, K, L) int32 emitted tokens
    scores: Optional[torch.Tensor]  # (G, K) f32 cumulative beam log-probs
    lps: Optional[torch.Tensor]     # (G, K, L) f32 per-token log-probs
    finished: torch.Tensor          # (G, K) bool
    tokens: torch.Tensor            # (G*K,) int64 next-step input tokens
    step: torch.Tensor              # (G,) int32 per-group write position
    rng: Optional[Tuple[int, int]] = None


def _check_mode(mode: str) -> None:
    if mode not in ("beam", "greedy", "sample"):
        raise ValueError(f"unknown decode mode {mode!r}")


def init_core(state: DecodeState, G: int, K: int, L: int, *, mode: str,
              rng=None, want_lps: bool = True) -> CoreState:
    """Fresh decode-loop carry: BOS inputs, PAD buffers, beam 0 live
    (beam mode), write position 0.  ``rng``: the sample mode's threefry
    key (two ints, a JAX key's ``key_data``); beam mode drops it."""
    _check_mode(mode)
    dev = state.h.device
    if mode == "beam":
        scores = torch.full((G, K), NEG_INF, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        lps = None
        rng = None
    else:
        scores = None
        lps = (torch.zeros((G, K, L), dtype=torch.float32, device=dev)
               if want_lps else None)
    return CoreState(
        state=state,
        seqs=torch.full((G, K, L), PAD_ID, dtype=torch.int32, device=dev),
        scores=scores,
        lps=lps,
        finished=torch.zeros((G, K), dtype=torch.bool, device=dev),
        tokens=torch.full((G * K,), BOS_ID, dtype=torch.int64, device=dev),
        step=torch.zeros((G,), dtype=torch.int32, device=dev),
        rng=None if rng is None else key_words(rng),
    )


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 with the same order (``-0.0`` counts as
    ``0.0``): non-negative floats keep their bit pattern, negative ones
    map below zero in reverse magnitude order."""
    b = (x.float() + 0.0).view(torch.int32).long()
    return torch.where(b >= 0, b, -(b & 0x7FFFFFFF) - 1)


def select_top(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-``k`` of ``values`` (R, N) float32 by (value desc,
    index asc) -> ``(values (R, k), indices (R, k) int64)`` best first
    (see the module doc)."""
    n = values.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=values.device)
    comp = _ordered_bits(values) * (1 << 32) + (_LOW32 - idx)
    top = torch.topk(comp, k, dim=-1).indices
    return torch.gather(values, -1, top), top


def beam_log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Beam mode's ``log_softmax`` over the last axis, float32: ``(x -
    max) - log(sum exp(x - max))`` with the sum of the float32 exps
    taken in float64, so a vocab split over shards, whose float64
    partial sums fold in another order (:func:`make_tp_beam_topk`),
    rounds its normalizer to the same float32 bits: the sharded beam
    selects the one-device candidates, near-ties across beams included
    (a per-beam shift of an ulp would reorder them)."""
    x = logits.float()
    d = x - x.max(dim=-1, keepdim=True).values
    s = torch.exp(d).sum(dim=-1, keepdim=True, dtype=torch.float64)
    return d.sub_(torch.log(s).float())


def greedy_pick(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy decision rule: per row of ``logits`` (R, V), the lowest
    index of the largest ``log_softmax`` value, and that value -> (token
    (R,) int64, log-prob (R,) float32).  :func:`decode_step`'s greedy
    mode and the speculative round (``decoding/speculative.py``) both
    pick through it, so a verified token is the one the plain loop would
    have emitted, ties included."""
    tok_lp, nxt = select_top(torch.log_softmax(logits.float(), dim=-1), 1)
    return nxt[:, 0], tok_lp[:, 0]


def _merge_candidates(values: torch.Tensor, keys: torch.Tensor, k: int):
    """Exact top-``k`` of a candidate union (G, W) by (value desc, key
    asc), ``lax.top_k``'s order over values laid out by ascending key:
    one ``topk`` over unique int64 composites of the value's ordered
    bits and the complemented key (keys < 2**32)."""
    comp = _ordered_bits(values) * (1 << 32) + (_LOW32 - keys)
    top = torch.topk(comp, k, dim=-1).indices
    return torch.gather(values, -1, top), torch.gather(keys, -1, top)


def _tp_log_softmax(logits: VocabShardedLogits):
    """Each shard's tile of :func:`beam_log_softmax`: the global max
    (exact) and the shards' float64 sums of exp folded in shard
    order."""
    lead = logits.lead
    m = pmax([x.max(dim=-1, keepdim=True).values for x in logits.shards],
             lead)
    ds = [x - m.to(x.device) for x in logits.shards]
    s = psum([torch.exp(d).sum(dim=-1, keepdim=True, dtype=torch.float64)
              for d in ds], lead)
    ls = torch.log(s).float()
    return [d.sub_(ls.to(d.device)) for d in ds]


def make_tp_beam_topk(mesh=None, axis: str = "model") -> Callable:
    """A beam-mode ``topk_fn`` for :func:`decode_step` that merges
    per-shard top-K candidates instead of gathering the vocab (reference
    ``make_tp_beam_topk``).  The logits handed to it are the model
    hook's ``VocabShardedLogits``; the merge lands on their lead device
    (``mesh`` and ``axis`` name the layout, as in the reference, and are
    read from the logits themselves)."""
    del mesh, axis

    def topk(logits: VocabShardedLogits, st: CoreState):
        G, K = st.finished.shape
        V, vloc, lead = logits.V, logits.vloc, logits.lead
        cand_sc, cand_key = [], []
        for j, lp in enumerate(_tp_log_softmax(logits)):
            d = lp.device
            lp = lp.reshape(G, K, vloc)
            # Frozen finished beams: PAD-only continuation at zero cost;
            # the PAD column lives on one shard, the rest collapse.
            gcol = torch.arange(vloc, device=d) + logits.col0(j)
            pad_only = torch.where(gcol == PAD_ID, 0.0, NEG_INF)
            lp = torch.where(st.finished.to(d)[..., None], pad_only, lp)
            total = st.scores.to(d)[..., None] + lp          # (G, K, vloc)
            sc, flat = select_top(total.reshape(G, K * vloc), K)
            # Local flat key k*vloc + v -> global k*V + v_global (monotone
            # within a shard, so the local tie order holds).
            lk = torch.div(flat, vloc, rounding_mode="floor")
            cand_sc.append(sc.to(lead))
            cand_key.append((lk * V + logits.col0(j) + flat
                             - lk * vloc).to(lead))
        return _merge_candidates(torch.cat(cand_sc, -1),
                                 torch.cat(cand_key, -1), K)

    return topk


def make_tp_row_pick(mesh=None, axis: str = "model") -> Callable:
    """Greedy-mode ``pick_fn`` twin of :func:`make_tp_beam_topk`: each
    shard takes the lowest-index maximum of its log-softmax tile (the
    normalizer folded from the shards' float32 max and sum of exp, as
    the reference folds it), and the (value, global id) winners merge by
    (value desc, id asc), the order of :func:`greedy_pick`."""
    del mesh, axis

    def pick(logits: VocabShardedLogits):
        lead = logits.lead
        vals, ids = [], []
        # The reference's fold: float32 partial sums in shard order (an
        # ulp of shift cannot move an argmax).
        m, s = logits.log_softmax_stats()
        ls = torch.log(s)
        for j, x in enumerate(logits.shards):
            lp = (x - m.to(x.device)) - ls.to(x.device)
            v, i = select_top(lp, 1)
            vals.append(v.to(lead))
            ids.append((i + logits.col0(j)).to(lead))
        best_v, best_i = _merge_candidates(torch.cat(vals, -1),
                                           torch.cat(ids, -1), 1)
        return best_i[:, 0], best_v[:, 0]

    return pick


def decode_step(step_logits: Callable, st: CoreState, *, mode: str,
                temperature: float = 1.0, sample_fn: Optional[Callable] = None,
                topk_fn: Optional[Callable] = None,
                pick_fn: Optional[Callable] = None) -> CoreState:
    """One decode step over every row of ``st``.

    ``step_logits(state, tokens) -> (state, logits)`` is the model hook:
    one decoder step returning float32 decode-policy logits (PAD/BOS
    masked out, ``CaptionModel.decode_logits``).  Modes:

    * ``"beam"``: top-K over ``score + log_softmax(logits)`` with
      PAD-frozen finished beams;
    * ``"greedy"``: argmax of ``log_softmax(logits)``;
    * ``"sample"``: multinomial over ``scaled = logits / temperature``.
      ``sample_fn(scaled, key, st) -> (token (G,), log_softmax(scaled)
      [token] (G,))`` is the noise source (``key`` is the step's split of
      ``st.rng``, or None when the carry holds no key, as for
      :func:`row_sample_fn`); None draws from the batch stream of
      ``jax.random.categorical`` on that key.  The reference's hook
      returns the token alone and takes its log-prob from the
      log-softmax: the port's kernel computes both in one pass.

    In the row modes finished rows emit PAD at zero log-prob.

    ``topk_fn(logits, st) -> (top scores (G, K), flat keys k*V + v (G,
    K))`` replaces the beam mode's top-K, ``pick_fn(logits) -> (token
    (G,), log-prob (G,))`` the greedy pick (:func:`make_tp_beam_topk`,
    :func:`make_tp_row_pick`).  ``VocabShardedLogits`` without a hook
    (and in sample mode) are gathered whole first."""
    _check_mode(mode)
    G, K, L = st.seqs.shape
    dev = st.seqs.device
    write = (torch.arange(L, device=dev)[None, :]
             == st.step[:, None].long())                     # (G, L)

    if mode == "beam":
        state, logits = step_logits(st.state, st.tokens)
        V = logits.shape[-1]
        if topk_fn is not None:
            top_scores, top_flat = topk_fn(logits, st)
        else:
            if isinstance(logits, VocabShardedLogits):
                logits = logits.gather(dev)
            logp = beam_log_softmax(logits).reshape(G, K, V)
            # Frozen finished beams: only the PAD continuation, at zero
            # cost.
            pad_only = torch.full((V,), NEG_INF, dtype=torch.float32,
                                  device=dev)
            pad_only[PAD_ID] = 0.0
            logp = torch.where(st.finished[..., None], pad_only, logp)
            total = st.scores[..., None] + logp              # (G, K, V)
            top_scores, top_flat = select_top(total.reshape(G, K * V), K)
        parent = torch.div(top_flat, V, rounding_mode="floor")
        tok = top_flat - parent * V                          # (G, K)
        g_ix = torch.arange(G, device=dev)[:, None]
        seqs = st.seqs[g_ix, parent]                         # reorder history
        seqs = torch.where(write[:, None, :], tok[:, :, None].int(), seqs)
        finished = (st.finished[g_ix, parent] | (tok == EOS_ID)
                    | (tok == PAD_ID))
        flat_parent = (g_ix * K + parent).reshape(-1)
        state = DecodeState(h=state.h[:, flat_parent],
                            c=state.c[:, flat_parent])
        # Finished beams feed EOS so the next-step embedding is defined.
        next_tok = torch.where(tok == PAD_ID, EOS_ID, tok).reshape(-1)
        return CoreState(state=state, seqs=seqs, scores=top_scores,
                         lps=st.lps, finished=finished, tokens=next_tok,
                         step=torch.clamp(st.step + 1, max=L), rng=st.rng)

    if K != 1:
        raise ValueError(f"row modes decode K=1 rows per group, got K={K}")
    rng, key = st.rng, None
    if mode == "sample" and rng is not None:
        rng, key = split(rng)
    state, logits = step_logits(st.state, st.tokens)
    if isinstance(logits, VocabShardedLogits) and (
            mode == "sample" or pick_fn is None):
        logits = logits.gather(dev)
    if mode == "greedy":
        nxt, tok_lp = (pick_fn or greedy_pick)(logits)       # (G,)
    else:
        scaled = logits.float() / torch.tensor(temperature,
                                               dtype=torch.float32)
        if sample_fn is not None:
            nxt, tok_lp = sample_fn(scaled, key, st)
        elif key is None:
            raise ValueError("sample mode needs a key in the carry "
                             "(init_core(rng=...)) or a sample_fn")
        else:
            nxt, tok_lp = threefry_sample(scaled, key=key)
    valid = ~st.finished[:, 0]
    out_tok = torch.where(valid, nxt, PAD_ID)
    out_lp = torch.where(valid, tok_lp, 0.0)
    finished = st.finished | ((nxt == EOS_ID) | (nxt == PAD_ID))[:, None]
    # Feed EOS (not raw PAD) so the next-step input embedding is defined.
    feed = torch.where(out_tok == PAD_ID, EOS_ID, out_tok)
    seqs = torch.where(write[:, None, :], out_tok[:, None, None].int(),
                       st.seqs)
    lps = st.lps
    if lps is not None:
        lps = torch.where(write[:, None, :], out_lp[:, None, None], lps)
    return CoreState(state=state, seqs=seqs, scores=st.scores, lps=lps,
                     finished=finished, tokens=feed,
                     step=torch.clamp(st.step + 1, max=L), rng=rng)


def row_sample_fn(base_key, row_id: torch.Tensor,
                  is_sample: Optional[torch.Tensor] = None) -> Callable:
    """Row-keyed multinomial noise for :func:`decode_step` sample mode
    (reference ``row_sample_fn``): row ``r`` at its own decode position
    ``t`` draws from ``fold_in(fold_in(base_key, row_id[r]), t)``, so
    neither its slot nor the rows beside it can change its token.
    ``is_sample`` (G,) bool: rows marked False take the greedy argmax
    (the CST greedy-baseline rows in the same slot matrix)."""
    base = key_words(base_key)

    def fn(scaled: torch.Tensor, key, st: CoreState):
        del key  # the carry holds no key: rows key themselves
        return threefry_sample(scaled, base=base, row_id=row_id,
                               step=st.step, is_sample=is_sample)

    return fn


def all_done(st: CoreState) -> bool:
    """Every row of every group has finished (one host sync)."""
    return bool(st.finished.all())
