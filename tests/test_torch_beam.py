"""Port parity: ``cst_captioning_torch.ops.beam`` (plain version of the
fused beam kernel) against the JAX package's ``ops/pallas_beam.py``.

The same numpy inputs (made from a seed) go through the JAX twin
``lstm_beam_scan`` — and, in one tiny case, through the Pallas kernel
``lstm_beam`` itself in interpret mode — and through
``lstm_beam_ref``.  At float32 the tokens must match exactly and the
raw beam scores within 1e-4 (the two frameworks sum the GEMMs and the
log-sum-exp in different orders; tokens are held exactly because the
fixed seeds leave no candidate pair within that distance).

float16 compute against the JAX twin at float16: best-caption match >=
``F16_MATCH_FLOOR`` = 15/16 and score rtol <= ``F16_SCORE_RTOL`` = 1e-4
on the matching captions, both tighter than bfloat16's relaxed-serving
tier (0.75, 0.02).  The readings over seeds 0-4: every caption
matching, rtol at most 4.0e-6 (bfloat16 reads 0.6875-1.0 and up to
1.6e-4 on the same inputs).  The beam tile picker's ``Vt`` (the plain
version's log-sum-exp chunks) at float16 is bfloat16's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.analysis.jit_registry import (
    RELAXED_SERVING_MATCH_FLOOR,
    RELAXED_SERVING_SCORE_RTOL,
)
from cst_captioning_tpu.constants import BOS_ID, EOS_ID, PAD_ID, UNK_ID
from cst_captioning_tpu.decoding.beam import finalize_beams as jfinalize
from cst_captioning_tpu.ops import pallas_beam as jpb
from cst_captioning_tpu.ops.pallas_beam import lstm_beam, lstm_beam_scan
from cst_captioning_torch.decoding.beam import finalize_beams
from cst_captioning_torch.ops import beam as tbeam
from cst_captioning_torch.ops.decode_common import beam_pick_tiles, row_topk

SCORE_ATOL = 1e-4
F16_MATCH_FLOOR = 15 / 16
F16_SCORE_RTOL = 1e-4


def make_args(B=3, H=16, E=16, V=50, seed=0, logit_scale=0.3):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=0.3: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    return dict(
        gx_static=(rng.randn(B, 4 * H) * 0.1).astype(np.float32),
        w_x=f(E, 4 * H),
        wh=f(H, 4 * H),
        emb=f(V, E),
        w_out=f(H, V, sc=logit_scale),
        b_out=(rng.randn(V) * 0.1).astype(np.float32),
    )


def run_jax(args, fn=lstm_beam_scan, **kw):
    s, sc = fn(*(jnp.asarray(v) for v in args.values()), **kw)
    return np.asarray(s), np.asarray(sc)


def run_port(args, fn=tbeam.lstm_beam_ref, **kw):
    s, sc = fn(*(torch.from_numpy(v) for v in args.values()), **kw)
    return s.numpy(), sc.numpy()


def assert_match(j, p):
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("beam_size,max_len,seed", [
    (1, 8, 0), (3, 8, 1), (5, 10, 2), (4, 6, 3),
])
def test_ref_matches_jax_twin(beam_size, max_len, seed):
    args = make_args(seed=seed)
    kw = dict(beam_size=beam_size, max_len=max_len)
    j, p = run_jax(args, **kw), run_port(args, **kw)
    assert_match(j, p)
    assert p[0].shape == (3, beam_size, max_len) and p[0].dtype == np.int32


def test_multi_tile_vocab_with_padding():
    """V=1100 spans several 512-wide reference tiles plus a padded tail:
    the chunked log-sum-exp and the per-tile top-K merge must agree and
    padded columns must never be chosen."""
    args = make_args(V=1100, H=32, E=32, seed=4)
    j = run_jax(args, beam_size=4, max_len=6)
    p = run_port(args, beam_size=4, max_len=6)
    assert_match(j, p)
    assert p[0].max() < 1100


def test_suppress_unk():
    args = make_args(V=24, seed=3)
    args["b_out"][UNK_ID] = 50.0
    kw = dict(beam_size=3, max_len=5)
    on_j = run_jax(args, suppress_unk=True, **kw)
    on_p = run_port(args, suppress_unk=True, **kw)
    assert_match(on_j, on_p)
    assert not np.any(on_p[0] == UNK_ID)
    off_p = run_port(args, suppress_unk=False, **kw)
    assert np.all(off_p[0][:, 0, 0] == UNK_ID)


def test_eos_freeze_emits_pad_and_holds_score():
    args = make_args(V=24, seed=5)
    args["b_out"][EOS_ID] = 50.0
    kw = dict(beam_size=3, max_len=6)
    j, p = run_jax(args, **kw), run_port(args, **kw)
    assert_match(j, p)
    eos_rows = p[0][:, :, 0] == EOS_ID
    assert eos_rows.any(axis=1).all()
    assert np.all(p[0][eos_rows][:, 1:] == PAD_ID)


def test_duplicate_vocab_columns_tie_to_lower_id():
    args = make_args(V=30, seed=7)
    lo, hi = 10, 20
    args["w_out"][:, hi] = args["w_out"][:, lo]
    args["b_out"][hi] = args["b_out"][lo]
    args["b_out"][lo] += 30.0
    args["b_out"][hi] += 30.0
    kw = dict(beam_size=3, max_len=4)
    j, p = run_jax(args, **kw), run_port(args, **kw)
    assert_match(j, p)
    assert np.all(p[0][:, 0, 0] == lo)


def test_never_emits_pad_or_bos_while_live():
    args = make_args(V=24, seed=9)
    args["b_out"][PAD_ID] = 50.0
    args["b_out"][BOS_ID] = 49.0
    kw = dict(beam_size=3, max_len=6)
    j, p = run_jax(args, **kw), run_port(args, **kw)
    assert_match(j, p)
    assert not np.any(p[0][:, :, 0] == BOS_ID)


def test_ref_matches_pallas_kernel_interpret():
    """The Pallas kernel itself, in interpret mode on the CPU."""
    args = make_args(B=2, H=8, E=8, V=20, seed=11)
    kw = dict(beam_size=3, max_len=5)
    j = run_jax(args, fn=lstm_beam, **kw)
    p = run_port(args, **kw)
    assert_match(j, p)


def test_wrapper_takes_plain_version_on_cpu():
    args = make_args(seed=12)
    kw = dict(beam_size=3, max_len=6)
    before = tbeam.lstm_beam.launches
    a = run_port(args, fn=tbeam.lstm_beam, **kw)
    b = run_port(args, **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert tbeam.lstm_beam.launches == before


def test_row_topk_tie_order():
    vals = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    ids = torch.tensor([[4, 9, 2, 0, 7]])
    v, i = row_topk(vals, ids, 4)
    assert v.tolist() == [[3.0, 3.0, 3.0, 2.0]]
    assert i.tolist() == [[2, 7, 9, 0]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_relaxed_serving_tier_vs_jax(seed):
    """bfloat16 operands: the two frameworks sum the f32 products in
    different orders, so a logit can round to a neighbouring bf16 value
    and a near-tied beam can flip.  Held at the reference's
    relaxed-serving tier: best-caption match >= the pinned floor, score
    rtol <= the pinned bound on the matching captions."""
    rng = np.random.RandomState(seed)
    B, H, E, V = 16, 32, 32, 600
    f = lambda *s, sc=0.3: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    args = dict(gx_static=f(B, 4 * H, sc=0.1), w_x=f(E, 4 * H, sc=0.1),
                wh=f(H, 4 * H, sc=0.1), emb=f(V, E), w_out=f(H, V),
                b_out=f(V, sc=0.1))
    f32 = ("gx_static", "b_out")
    kw = dict(beam_size=3, max_len=10)
    j = jfinalize(*lstm_beam_scan(*(
        jnp.asarray(v, jnp.float32 if k in f32 else jnp.bfloat16)
        for k, v in args.items()), **kw))
    p = finalize_beams(*tbeam.lstm_beam_ref(*(
        torch.from_numpy(v).to(torch.float32 if k in f32 else torch.bfloat16)
        for k, v in args.items()), **kw))
    same = (np.asarray(j.tokens) == p.tokens.numpy()).all(-1)
    assert same.mean() >= RELAXED_SERVING_MATCH_FLOOR
    js = np.asarray(j.score)[same]
    rtol = np.abs(js - p.score.numpy()[same]) / np.abs(js)
    assert rtol.max() <= RELAXED_SERVING_SCORE_RTOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f16_tier_vs_jax(seed):
    """float16 operands against the JAX twin at float16 (module
    docstring's tier)."""
    rng = np.random.RandomState(seed)
    B, H, E, V = 16, 32, 32, 600
    f = lambda *s, sc=0.3: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    args = dict(gx_static=f(B, 4 * H, sc=0.1), w_x=f(E, 4 * H, sc=0.1),
                wh=f(H, 4 * H, sc=0.1), emb=f(V, E), w_out=f(H, V),
                b_out=f(V, sc=0.1))
    f32 = ("gx_static", "b_out")
    kw = dict(beam_size=3, max_len=10)
    j = jfinalize(*lstm_beam_scan(*(
        jnp.asarray(v, jnp.float32 if k in f32 else jnp.float16)
        for k, v in args.items()), **kw))
    p = finalize_beams(*tbeam.lstm_beam_ref(*(
        torch.from_numpy(v).to(torch.float32 if k in f32 else torch.float16)
        for k, v in args.items()), **kw))
    same = (np.asarray(j.tokens) == p.tokens.numpy()).all(-1)
    assert same.mean() >= F16_MATCH_FLOOR
    js = np.asarray(j.score)[same]
    rtol = np.abs(js - p.score.numpy()[same]) / np.abs(js)
    assert rtol.max() <= F16_SCORE_RTOL


@pytest.mark.parametrize("B,K,F,A", [(64, 5, 0, 0), (16, 3, 0, 0),
                                     (64, 5, 56, 512)])
def test_f16_beam_tiles_are_bf16s(B, K, F, A):
    got = beam_pick_tiles(B, K, F, A, 512, 512, 30, 2)
    assert got == jpb._pick_tiles(B, K, F, A, 512, 512, 30,
                                  jnp.dtype(jnp.float16).itemsize)
