"""The one autoregressive decode step (port of the JAX package's
``decoding/core.py``, beam and greedy modes).

* :class:`DecodeState`: the per-layer ``(h, c)`` carry.
* :class:`CoreState`: the decode-loop carry over G row groups of K rows
  (beam: K = beam width; greedy: K = 1): LSTM state, token buffers,
  beam scores, finished flags, next-step input tokens and per-group
  write positions.
* :func:`decode_step`: the per-step recurrence every per-step consumer
  drives: the offline beam (``decoding/beam.py::beam_search_from_state``),
  per-step greedy (``CaptionModel._sample_from_cache``) and the
  continuous slot loop (``serving/slots.py``).  Beam mode keeps the
  reference's PAD-freeze of finished beams, parent gather, EOS/PAD
  finish and PAD->EOS feed; greedy mode its argmax with PAD at zero
  log-prob after the end.

Write positions are per-group counters (``CoreState.step``): offline
loops advance all groups together, the slot loop holds groups at
different depths in one matrix.

Selection order.  Beam top-K ranks by (value desc, flat key ``k*V + v``
asc), the order ``lax.top_k`` gives; greedy takes the lowest index of
the largest log-prob, ``jnp.argmax``'s.  ``torch.topk`` promises no
order among ties, so :func:`select_top` ranks int64 composites: an
order-preserving integer image of the float value in the high 32 bits
and the complement of the flat index in the low 32.  Composites are
unique, so one ``topk`` over them is exact, tie order included, on any
device and for any row count.

Not ported (raise ``NotImplementedError``): ``mode="sample"`` and its
``sample_fn`` noise hook (CST's slot rollout, ROADMAP Queue 1 item 1),
and the ``topk_fn`` / ``pick_fn`` selection hooks (the tensor-parallel
candidate merge, Queue 1 item 7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID

NEG_INF = -1e30
_LOW32 = (1 << 32) - 1


class DecodeState(NamedTuple):
    """Autoregressive decoder carry: per-layer (h, c)."""

    h: torch.Tensor  # (num_layers, B, H) compute dtype
    c: torch.Tensor  # (num_layers, B, H) float32


class CoreState(NamedTuple):
    """Carry of the decode loop over G groups of K rows (flat row axis
    ``G*K``).  ``scores`` is None in greedy mode, ``lps`` None in beam
    mode or when not wanted; ``rng`` is always None (no sample mode)."""

    state: DecodeState              # (layers, G*K, H) LSTM carry
    seqs: torch.Tensor              # (G, K, L) int32 emitted tokens
    scores: Optional[torch.Tensor]  # (G, K) f32 cumulative beam log-probs
    lps: Optional[torch.Tensor]     # (G, K, L) f32 per-token log-probs
    finished: torch.Tensor          # (G, K) bool
    tokens: torch.Tensor            # (G*K,) int64 next-step input tokens
    step: torch.Tensor              # (G,) int32 per-group write position
    rng: Optional[torch.Tensor] = None


def _not_ported(what: str, item: str) -> NotImplementedError:
    from cst_captioning_torch.models.captioner import not_ported

    return not_ported(what, item)


def _check_mode(mode: str) -> None:
    if mode == "sample":
        raise _not_ported("decode mode 'sample' (multinomial per-step "
                          "decode)", "Queue 1, item 1 (CST)")
    if mode not in ("beam", "greedy"):
        raise ValueError(f"unknown decode mode {mode!r}")


def init_core(state: DecodeState, G: int, K: int, L: int, *, mode: str,
              rng=None, want_lps: bool = True) -> CoreState:
    """Fresh decode-loop carry: BOS inputs, PAD buffers, beam 0 live
    (beam mode), write position 0."""
    _check_mode(mode)
    if rng is not None:
        raise _not_ported("a sampling rng in the decode carry",
                          "Queue 1, item 1 (CST)")
    dev = state.h.device
    if mode == "beam":
        scores = torch.full((G, K), NEG_INF, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        lps = None
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


def decode_step(step_logits: Callable, st: CoreState, *, mode: str,
                temperature: float = 1.0, sample_fn: Optional[Callable] = None,
                topk_fn: Optional[Callable] = None,
                pick_fn: Optional[Callable] = None) -> CoreState:
    """One decode step over every row of ``st``.

    ``step_logits(state, tokens) -> (state, logits)`` is the model hook:
    one decoder step returning float32 decode-policy logits (PAD/BOS
    masked out, ``CaptionModel.decode_logits``).  ``mode`` is ``"beam"``
    (top-K over ``score + log_softmax(logits)`` with PAD-frozen finished
    beams) or ``"greedy"`` (argmax of ``log_softmax(logits)``; finished
    rows emit PAD at zero log-prob).  ``temperature`` only matters in
    the unported sample mode."""
    _check_mode(mode)
    if sample_fn is not None:
        raise _not_ported("decode_step's sample_fn noise hook",
                          "Queue 1, item 1 (CST)")
    if topk_fn is not None or pick_fn is not None:
        raise _not_ported("decode_step's topk_fn / pick_fn selection hooks",
                          "Queue 1, item 7 (multi-GPU)")
    G, K, L = st.seqs.shape
    dev = st.seqs.device
    write = (torch.arange(L, device=dev)[None, :]
             == st.step[:, None].long())                     # (G, L)
    state, logits = step_logits(st.state, st.tokens)
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)

    if mode == "beam":
        logp = logp.reshape(G, K, V)
        # Frozen finished beams: only the PAD continuation, at zero cost.
        pad_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=dev)
        pad_only[PAD_ID] = 0.0
        logp = torch.where(st.finished[..., None], pad_only, logp)
        total = st.scores[..., None] + logp                  # (G, K, V)
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
    tok_lp, nxt = select_top(logp, 1)
    nxt, tok_lp = nxt[:, 0], tok_lp[:, 0]                    # (G,)
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
                     step=torch.clamp(st.step + 1, max=L), rng=st.rng)


def all_done(st: CoreState) -> bool:
    """Every row of every group has finished (one host sync)."""
    return bool(st.finished.all())
