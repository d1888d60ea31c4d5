"""Speculative greedy decode: draft-LSTM propose, full-model verify (port
of the JAX package's ``decoding/speculative.py``).

A tiny draft LSTM (``serving.speculative.draft_hidden`` units) proposes
``draft_k`` greedy tokens from its own carry, and the full model verifies
them in one round: ``CaptionModel.decode_verify`` chains the k
recurrence steps and runs the k vocab products as one ``row_dot`` over
k*G rows.  The accepted prefix is the longest run where the draft's
proposals equal the model's own greedy stream, plus the model's next
token after the first disagreement (the standard rejection rule), so the
emitted tokens are exactly the non-speculative greedy decode's: every
emitted token is the full model's pick (``decoding/core.py::
greedy_pick``, the rule ``decode_step`` applies) from the state the
plain loop would have had.  The draft changes only how many rounds a
caption takes.  On the card the verify's products, like the plain
step's, go through the row-invariant ``row_gemm`` kernel, so a verify
row is bit for bit the plain step's row.

The draft is a single LSTM layer over the word embedding alone (no
context, no category), all float32, initialized by truncating the full
checkpoint (:func:`make_draft_params`); ``cli/distill_draft.py`` trains
the same shapes against the full model's greedy stream and saves the
``.npz`` that ``serving.speculative.draft_params`` names.  The file
format (:data:`DRAFT_LEAVES`) is the reference's, so a draft written by
either package loads in the other.

:func:`spec_round` is one propose / verify round over the decode core's
``CoreState`` plus a (2, G, draft_hidden) draft carry; the slot loop
(``serving/slots.py``) drives it ``slot_block_steps`` times a tick.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cst_captioning_torch.constants import EOS_ID
from cst_captioning_torch.decoding.core import (
    CoreState,
    DecodeState,
    greedy_pick,
    select_top,
)
from cst_captioning_torch.models.captioner import CaptionModel
from cst_captioning_torch.ops import quant
from cst_captioning_torch.ops.rnn import dot_f32, gate_update
from cst_captioning_torch.ops.rowgemm import row_dot
from cst_captioning_torch.parallel.collectives import VocabShardedLogits

# The draft tree's leaf names (the reference's, and its .npz keys).  They
# match none of the full model's quantizable leaf patterns.
DRAFT_LEAVES = (
    "draft_embed",
    "draft_cell_w",
    "draft_cell_b",
    "draft_head_w",
    "draft_head_b",
)

DEFAULT_DRAFT_K = 4
DEFAULT_DRAFT_HIDDEN = 128


class SpecConfig(NamedTuple):
    """Parsed ``serving.speculative`` section."""

    draft_k: int                  # proposals verified per round (>= 2)
    draft_hidden: int             # draft LSTM width
    draft_params: str             # optional distilled .npz path ("")


def spec_config(serving_cfg) -> Optional[SpecConfig]:
    """Parse ``serving.speculative`` (empty = off, unknown keys refused);
    None when speculation is off."""
    raw = dict(getattr(serving_cfg, "speculative", None) or {})
    if not raw:
        return None
    unknown = set(raw) - {"draft_k", "draft_hidden", "draft_params"}
    if unknown:
        raise ValueError(
            f"unknown serving.speculative key(s) {sorted(unknown)} — "
            "expected draft_k / draft_hidden / draft_params")
    k = int(raw.get("draft_k", DEFAULT_DRAFT_K))
    hidden = int(raw.get("draft_hidden", DEFAULT_DRAFT_HIDDEN))
    path = str(raw.get("draft_params", "") or "")
    if k < 2:
        raise ValueError(
            f"serving.speculative.draft_k = {k} — speculation needs at "
            "least 2 (1 draft proposal + the model's own next token); "
            "use an empty dict to disable")
    if hidden < 1:
        raise ValueError(
            f"serving.speculative.draft_hidden = {hidden} must be >= 1")
    return SpecConfig(draft_k=k, draft_hidden=hidden, draft_params=path)


# ------------------------------------------------------------ draft init

def _host_f32(p: Dict[str, Any], name: str) -> np.ndarray:
    """A full-model leaf as host float32, dequantized first when the tree
    is the int8w serving tree (``ops/quant.py::dequantize``, the
    reference's product of codes and scales); a bf16 / f16 leaf (a
    torch tensor, or an ``ml_dtypes`` array of a JAX tree) widens
    exactly, as the reference's ``np.asarray(leaf, np.float32)``."""
    leaf = p[name]
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
    else:
        a = np.asarray(leaf)
        leaf = torch.from_numpy(np.array(
            a if a.dtype == np.int8 else a.astype(np.float32)))
    axis = quant.quant_axis(name)
    if axis is not None and leaf.dtype == torch.int8:
        scale = p[name + quant.SCALE_SUFFIX]
        scale = (scale.detach().cpu() if isinstance(scale, torch.Tensor)
                 else torch.from_numpy(np.array(scale)))
        leaf = quant.dequantize(leaf, scale, axis)
    return leaf.float().numpy()


def make_draft_params(params, draft_hidden: int) -> Dict[str, np.ndarray]:
    """Truncation init of the draft tree from the full model's weights (a
    port state dict or a JAX ``{"params": ...}`` tree, float or int8w):
    the first ``draft_hidden`` units of the embedding, the layer-0 LSTM
    (input-slice + hidden-slice rows, the matching column slice of each
    i|f|g|o gate, so the forget bias survives) and the vocab head."""
    p = params["params"] if "params" in params else params
    we = _host_f32(p, "word_embed")             # (V, E)
    lw = _host_f32(p, "lstm0_w")                # (in_dim + H, 4H)
    lb = _host_f32(p, "lstm0_b")                # (4H,)
    gw = _host_f32(p, "logit_w")                # (H, V)
    gb = _host_f32(p, "logit_b")                # (V,)
    H = lb.shape[0] // 4
    E = we.shape[1]
    in_dim = lw.shape[0] - H
    d = int(draft_hidden)
    if not 1 <= d <= min(E, H):
        raise ValueError(
            f"serving.speculative.draft_hidden = {d} must lie in "
            f"[1, min(embed_size={E}, rnn_size={H})] for truncation "
            "init from the full checkpoint")
    rows = np.concatenate([lw[:d], lw[in_dim: in_dim + d]], axis=0)
    cell_w = np.concatenate([rows[:, g * H: g * H + d] for g in range(4)],
                            axis=1)
    cell_b = np.concatenate([lb[g * H: g * H + d] for g in range(4)], axis=0)
    return {
        "draft_embed": np.ascontiguousarray(we[:, :d]),
        "draft_cell_w": cell_w,                 # (2d, 4d), gates i|f|g|o
        "draft_cell_b": cell_b,                 # (4d,)
        "draft_head_w": np.ascontiguousarray(gw[:d]),   # (d, V)
        "draft_head_b": gb,                     # (V,)
    }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def save_draft_params(path: str, dp: Dict[str, Any]) -> None:
    """Write a draft tree as the ``.npz`` ``serving.speculative.
    draft_params`` names (``cli/distill_draft.py``'s output)."""
    np.savez(path, **{k: _host(dp[k]) for k in DRAFT_LEAVES})


def load_draft_params(path: str) -> Dict[str, np.ndarray]:
    """Load a draft tree; a file missing a leaf fails at boot."""
    with np.load(path) as z:
        missing = set(DRAFT_LEAVES) - set(z.files)
        if missing:
            raise ValueError(
                f"draft params {path!r} missing leaves {sorted(missing)}")
        return {k: np.asarray(z[k], np.float32) for k in DRAFT_LEAVES}


def draft_to_device(dp: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The draft tree as float32 tensors on ``device`` (copies: training
    the tree in place never writes into ``dp``)."""
    return {k: torch.tensor(_host(dp[k])).to(device) for k in DRAFT_LEAVES}


# ---------------------------------------------------------- draft step

def draft_logits(dp: Dict[str, torch.Tensor], carry: torch.Tensor,
                 tok: torch.Tensor, suppress_unk: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One draft step -> ``(carry', float32 logits masked by the decode
    policy, ``CaptionModel.mask_decode_logits``)``.  ``carry`` (2, G, Hd)
    float32 (h row 0, c row 1), ``tok`` (G,).  Without
    autograd (serving) both products go through ``row_dot`` (the
    ``row_gemm`` kernel on a card); under it (``cli/distill_draft.py``)
    through ``dot_f32``, which autograd differentiates."""
    dot = dot_f32 if torch.is_grad_enabled() else row_dot
    f32 = torch.float32
    emb = dp["draft_embed"][tok.long()]
    gates = (dot(torch.cat([emb, carry[0]], dim=-1), dp["draft_cell_w"], f32)
             + dp["draft_cell_b"])
    h_new, c_new = gate_update(gates, carry[1])
    logits = dot(h_new, dp["draft_head_w"], f32) + dp["draft_head_b"]
    return torch.stack([h_new, c_new]), CaptionModel.mask_decode_logits(
        logits, suppress_unk)


@torch.no_grad()
def draft_step(dp: Dict[str, torch.Tensor], carry: torch.Tensor,
               tok: torch.Tensor, suppress_unk: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy draft step -> ``(carry', proposal (G,) int64)``: the
    argmax (lowest index of the largest) of :func:`draft_logits`' logits,
    as the reference's ``jnp.argmax``.  Serving only: without autograd,
    so both products go through ``row_dot``."""
    carry, logits = draft_logits(dp, carry, tok, suppress_unk)
    return carry, select_top(logits, 1)[1][:, 0]


# ------------------------------------------------------------ the round

def spec_round(verify_fn: Callable, draft_fn: Callable, st: CoreState,
               carry: torch.Tensor, k: int,
               pick_fn: Optional[Callable] = None
               ) -> Tuple[CoreState, torch.Tensor, torch.Tensor]:
    """One speculative greedy round over ``st`` (K = 1 rows per group).

    ``draft_fn(carry, tok) -> (carry', proposal)`` is one draft step;
    ``verify_fn(state, tokens_k) -> (h_all, c_all, logits)`` the model's
    ``decode_verify`` with ``tokens_k`` (k, G) and flat logits (k*G, V);
    ``pick_fn`` picks from them (``decoding/core.py::make_tp_row_pick``
    under a sharded vocab; :func:`greedy_pick` by default, after a
    gather of sharded logits).  Returns ``(st', carry', stats)``, ``stats`` a (2,) float32 ``[tokens
    emitted, live rows]`` on the device (no host read).

    Row j of the verify computes the model's pick after consuming
    ``[tok0, p_0..p_{j-1}]``; accepting while ``p_j == m_j`` means each
    consumed proposal was the model's own pick, so each emitted ``m_j``
    is the plain loop's token.  The first disagreement still emits the
    model's token, an EOS ends the accepted prefix where the plain loop
    would stop, and finished or full rows emit nothing."""
    G = st.tokens.shape[0]
    L = st.seqs.shape[-1]
    dev = st.tokens.device
    # Draft: k proposals, one carry snapshot per consumed input; snaps[j]
    # is the carry to resume from when j + 1 tokens are accepted.
    props, snaps = [], []
    tok, c = st.tokens, carry
    for _ in range(k):
        c, tok = draft_fn(c, tok)
        snaps.append(c)
        props.append(tok)
    p = torch.stack(props, dim=1)                              # (G, k)
    snap = torch.stack(snaps)                                  # (k, 2, G, Hd)
    # Verify: the current token, then the first k - 1 proposals.
    vin = torch.cat([st.tokens[None, :], p[:, : k - 1].T], dim=0)
    h_all, c_all, logits = verify_fn(st.state, vin)
    if pick_fn is None and isinstance(logits, VocabShardedLogits):
        logits = logits.gather(dev)
    nxt, tok_lp = (pick_fn or greedy_pick)(logits)
    m = nxt.reshape(k, G).T                                    # (G, k)
    lp = tok_lp.reshape(k, G).T
    # The rejection rule: the longest draft / model agreement plus the
    # model's next token, cut at the model's EOS and the row's room.
    match = (p[:, : k - 1] == m[:, : k - 1]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)             # [0, k-1]
    pos = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
    eos_pos = torch.where(m == EOS_ID, pos[None, :],
                          torch.full_like(m, k + 1)).min(dim=1).values
    step = st.step.long()
    valid = ~st.finished[:, 0] & (step < L)
    room = torch.clamp(L - step, min=1)
    n_emit = torch.minimum(torch.minimum(n_acc + 1, eos_pos), room)
    n_emit = torch.where(valid, n_emit, torch.zeros_like(n_emit))
    eos_hit = valid & (eos_pos <= n_emit)
    finished = st.finished | eos_hit[:, None]
    new_step = torch.clamp(step + n_emit, max=L).to(st.step.dtype)
    idx = torch.clamp(n_emit - 1, 0, k - 1)                    # (G,)
    last_tok = m.gather(1, idx[:, None])[:, 0]
    tokens = torch.where(valid, last_tok, st.tokens)
    # Write the accepted prefix into the rows' buffers.
    ar_k = torch.arange(k, device=dev)
    write_pos = step[:, None] + ar_k[None, :]                  # (G, k)
    emit = (ar_k[None, :] < n_emit[:, None]) & (write_pos < L)
    onehot = ((write_pos[:, :, None]
               == torch.arange(L, device=dev)[None, None, :])
              & emit[:, :, None])                              # (G, k, L)
    written = onehot.any(dim=1)
    upd = torch.where(onehot, m[:, :, None], 0).sum(dim=1)
    seqs = torch.where(written, upd.to(st.seqs.dtype),
                       st.seqs[:, 0, :])[:, None, :]
    lps = st.lps
    if lps is not None:
        lp_upd = torch.where(onehot, lp[:, :, None], 0.0).sum(dim=1)
        lps = torch.where(written, lp_upd, st.lps[:, 0, :])[:, None, :]
    # Resume from the snapshot after the last accepted input (frozen rows
    # take snapshot 0: their emissions stay suppressed, and admission
    # resets every leaf).
    g = torch.arange(G, device=dev)
    state = DecodeState(
        h=h_all.permute(2, 0, 1, 3)[g, idx].transpose(0, 1).contiguous(),
        c=c_all.permute(2, 0, 1, 3)[g, idx].transpose(0, 1).contiguous())
    carry_new = snap.permute(2, 0, 1, 3)[g, idx].transpose(0, 1).contiguous()
    stats = torch.stack([n_emit.sum().float(), valid.sum().float()])
    new_st = st._replace(state=state, seqs=seqs, lps=lps, finished=finished,
                         tokens=tokens, step=new_step)
    return new_st, carry_new, stats
