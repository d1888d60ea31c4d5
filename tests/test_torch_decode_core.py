"""The port's decode core (``decoding/core.py``) against the JAX
package's on identical logits: beam and greedy steps, with constructed
ties (equal logits in a row, equal totals across beams, finished beams
riding frozen).  Tokens, parent keys, finished flags, fed tokens and the
gathered state must match bit for bit; scores and log-probs to float32
rounding (the two log-softmax implementations sum in other orders).

Each side's model hook ignores the model and returns the step's logits
from a table, with the LSTM state holding each row's id so the parent
gather of the state is checked too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.decoding import core as jcore
from cst_captioning_torch.constants import EOS_ID, PAD_ID
from cst_captioning_torch.decoding import core as tcore

V = 37


def _tables(steps, rows, seed, ties):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(steps, rows, V) * 2.0).astype(np.float32)
    if ties:
        for t in range(steps):
            for r in range(rows):
                top = int(lg[t, r].argmax())
                twin = (top + 7) % V
                if twin > 2:   # leave PAD / BOS / EOS alone
                    lg[t, r, twin] = lg[t, r, top]      # tie inside a row
            if rows > 1:
                lg[t, 1] = lg[t, 0]                     # identical rows
        lg[1, ::3, EOS_ID] = 50.0                       # some rows finish
    lg[:, :, PAD_ID] = -1e30                            # decode policy
    lg[:, :, 1] = -1e30
    return lg


def _run(lib, mode, G, K, L, logits, n_steps):
    """Drive ``n_steps`` decode steps of ``lib``'s core; returns the
    per-step snapshots as numpy."""
    is_jax = lib is jcore
    arr = (lambda x: jnp.asarray(x)) if is_jax else torch.from_numpy  # noqa: E731
    rows = G * K
    h = np.arange(rows, dtype=np.float32)[None, :, None] * np.ones(
        (1, 1, 2), np.float32)
    state = lib.DecodeState(h=arr(h), c=arr(h * 10.0))
    st = lib.init_core(state, G, K, L, mode=mode)
    fed = []

    def hook(s, tokens):
        fed.append(np.asarray(tokens).astype(np.int64))
        return s, arr(logits[len(fed) - 1])

    snaps = []
    for _ in range(n_steps):
        st = lib.decode_step(hook, st, mode=mode)
        snaps.append({
            "seqs": np.asarray(st.seqs),
            "finished": np.asarray(st.finished),
            "tokens": np.asarray(st.tokens).astype(np.int64),
            "step": np.asarray(st.step).astype(np.int64),
            "h": np.asarray(st.state.h),
            "c": np.asarray(st.state.c),
            "scores": None if st.scores is None else np.asarray(st.scores),
            "lps": None if st.lps is None else np.asarray(st.lps),
        })
    return snaps, fed


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("G,K", [(3, 4), (2, 1), (5, 3)])
def test_beam_steps_match_jax(G, K, ties):
    L, n = 6, 8                       # two steps past the length cap
    logits = _tables(n, G * K, seed=G * 10 + K, ties=ties)
    js, jf = _run(jcore, "beam", G, K, L, logits, n)
    ts, tf = _run(tcore, "beam", G, K, L, logits, n)
    for t, (a, b) in enumerate(zip(js, ts)):
        for k in ("seqs", "finished", "tokens", "step", "h", "c"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{k} @ {t}")
        np.testing.assert_allclose(b["scores"], a["scores"], rtol=1e-6,
                                   atol=1e-5)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b, a)
    if ties:
        assert (js[-1]["seqs"] == EOS_ID).any()   # frozen beams exercised


@pytest.mark.parametrize("ties", [False, True])
def test_greedy_steps_match_jax(ties):
    G, L, n = 7, 5, 7
    logits = _tables(n, G, seed=5, ties=ties)
    js, jf = _run(jcore, "greedy", G, 1, L, logits, n)
    ts, tf = _run(tcore, "greedy", G, 1, L, logits, n)
    for t, (a, b) in enumerate(zip(js, ts)):
        for k in ("seqs", "finished", "tokens", "step", "h", "c"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{k} @ {t}")
        np.testing.assert_allclose(b["lps"], a["lps"], rtol=1e-6, atol=1e-5)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b, a)


def test_select_top_tie_order():
    """(value desc, index asc) on ties, -0.0 equal to 0.0, negatives
    ordered by magnitude."""
    x = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, -5.0, 3.0, -1e30]])
    vals, idx = tcore.select_top(x, 6)
    assert idx.tolist() == [[1, 2, 6, 0, 3, 4]]
    assert vals[0, :3].tolist() == [3.0, 3.0, 3.0]
    vals, idx = tcore.select_top(-x, 3)
    assert idx.tolist() == [[7, 5, 3]]


def test_unported_modes_raise():
    st = tcore.init_core(tcore.DecodeState(torch.zeros(1, 2, 3),
                                           torch.zeros(1, 2, 3)),
                         2, 1, 4, mode="greedy")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.decode_step(lambda s, t: (s, None), st, mode="sample")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.decode_step(lambda s, t: (s, None), st, mode="greedy",
                          pick_fn=lambda lg: lg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.decode_step(lambda s, t: (s, None), st, mode="greedy",
                          sample_fn=lambda *a: a)
    with pytest.raises(ValueError, match="unknown decode mode"):
        tcore.decode_step(lambda s, t: (s, None), st, mode="nucleus")
    assert not tcore.all_done(st)
