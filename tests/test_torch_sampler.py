"""Port parity: ``cst_captioning_torch.ops.sampler`` (plain version of
the fused sampling kernel) against the JAX package's
``ops/pallas_sampler.py``.

The same numpy inputs and the same two seed words go through the JAX
twin ``lstm_sample_scan`` (and, in one tiny case, the Pallas kernel in
interpret mode) and through ``lstm_sample_ref``.  Greedy AND multinomial
tokens must match exactly at float32 — the port reproduces the
reference's murmur3 counter stream bit for bit — with log-probs within
1e-4 (different summation orders in the GEMMs and the log-sum-exp).

float16 compute (the meanpool sampler's float16 instantiation on the
card) against the JAX twin at float16: row match >= ``F16_MATCH_FLOOR``
= 15/16 (one caption of the 16 may flip on a near-tie) and summed
log-prob rtol <= ``F16_SCORE_RTOL`` = 1e-4 on the matching rows; both
tighter than bfloat16's relaxed-serving tier (0.75, 0.02).  The
readings, greedy and multinomial over seeds 20-22: every row matching,
rtol at most 9.5e-7 (bfloat16 reads 0.8125 and 2.0e-4 on the same
inputs).  The stream geometry at float16 is bfloat16's (the reference's
picker sees the itemsize, 2 for both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.analysis.jit_registry import (
    RELAXED_SERVING_MATCH_FLOOR,
    RELAXED_SERVING_SCORE_RTOL,
)
from cst_captioning_tpu.constants import EOS_ID, PAD_ID, UNK_ID
from cst_captioning_tpu.ops import pallas_sampler as jps
from cst_captioning_torch.ops import decode_common as dc
from cst_captioning_torch.ops import sampler as tsam

LP_ATOL = 1e-4
F16_MATCH_FLOOR = 15 / 16
F16_SCORE_RTOL = 1e-4


def make_args(B=8, H=16, E=16, V=50, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=0.3: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    return dict(
        gx_static=(rng.randn(B, 4 * H) * 0.1).astype(np.float32),
        w_x=f(E, 4 * H),
        wh=f(H, 4 * H),
        emb=f(V, E),
        w_out=f(H, V),
        b_out=(rng.randn(V) * 0.1).astype(np.float32),
    )


def run_jax(args, seed, fn=jps.lstm_sample_scan, **kw):
    out = fn(*(jnp.asarray(v) for v in args.values()),
             jnp.asarray(seed, jnp.int32), **kw)
    return tuple(np.asarray(x) for x in out)


def run_port(args, seed, fn=tsam.lstm_sample_ref, **kw):
    out = fn(*(torch.from_numpy(v) for v in args.values()), seed, **kw)
    return tuple(x.numpy() for x in out)


def assert_match(j, p):
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=LP_ATOL)
    np.testing.assert_array_equal(p[2], j[2])


@pytest.mark.parametrize("greedy,temperature,seed", [
    (True, 1.0, 0), (False, 1.0, 1), (False, 0.7, 2), (False, 1.5, 3),
])
def test_ref_matches_jax_twin(greedy, temperature, seed):
    args = make_args(seed=seed)
    words = [int(x) for x in np.random.RandomState(seed).randint(
        -2**31, 2**31 - 1, size=2)]
    kw = dict(max_len=10, greedy=greedy, temperature=temperature)
    j, p = run_jax(args, words, **kw), run_port(args, words, **kw)
    assert_match(j, p)
    assert p[0].dtype == np.int32 and p[0].shape == (8, 10)


def test_multinomial_multi_tile_and_batch_tiles():
    """V=1100 (several reference tiles, padded V_pad in the counter) and
    B=48 (several stream batch tiles of the seed-word mixing)."""
    args = make_args(B=48, V=1100, seed=5)
    kw = dict(max_len=6, greedy=False)
    j, p = run_jax(args, [123, -456], **kw), run_port(args, [123, -456], **kw)
    assert_match(j, p)


def test_seed_words_both_enter_the_stream():
    args = make_args(seed=6)
    kw = dict(max_len=8, greedy=False)
    a = run_port(args, [7, 1], **kw)
    b = run_port(args, [7, 2], **kw)
    assert not np.array_equal(a[0], b[0])
    assert_match(run_jax(args, [7, 2], **kw), b)


def test_finished_rows_emit_pad_and_mask():
    args = make_args(seed=7)
    args["b_out"][EOS_ID] = 8.0
    kw = dict(max_len=6, greedy=True)
    j, p = run_jax(args, 0, **kw), run_port(args, 0, **kw)
    assert_match(j, p)
    toks, lps, mask = p
    assert np.all(toks[:, 0] == EOS_ID) and np.all(mask[:, 0] == 1.0)
    assert np.all(toks[:, 1:] == PAD_ID) and np.all(lps[:, 1:] == 0.0)
    assert np.all(mask[:, 1:] == 0.0)


def test_suppress_unk():
    args = make_args(seed=8)
    args["b_out"][UNK_ID] = 20.0
    kw = dict(max_len=5, greedy=True, suppress_unk=True)
    j, p = run_jax(args, 0, **kw), run_port(args, 0, **kw)
    assert_match(j, p)
    assert not np.any(p[0] == UNK_ID)


def test_ref_matches_pallas_kernel_interpret():
    args = make_args(B=8, H=8, E=8, V=20, seed=9)
    for greedy in (True, False):
        kw = dict(max_len=5, greedy=greedy)
        j = run_jax(args, [11, 22], fn=jps.lstm_sample, **kw)
        p = run_port(args, [11, 22], **kw)
        assert_match(j, p)


def test_hash_stream_matches_reference_bits():
    rng = np.random.RandomState(10)
    z = rng.randint(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jps._fmix32(jnp.asarray(z)))
    got = dc.fmix32(torch.from_numpy(z.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    seed = np.uint32(0xDEADBEEF)
    gref = np.asarray(jps._gumbel_from_counter(jnp.asarray(z), seed))
    gp = dc.gumbel_from_counter(torch.from_numpy(z.astype(np.int64)),
                                int(seed)).numpy()
    np.testing.assert_allclose(gp, gref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,E,H,itemsize", [
    (64, 512, 512, 4), (64, 512, 512, 2), (8, 32, 32, 4), (48, 16, 16, 4),
])
def test_stream_geometry_matches_reference_picker(B, E, H, itemsize):
    assert dc.sampler_pick_tiles(B, 0, 0, E, H, itemsize) == \
        jps._pick_tiles(B, 0, 0, E, H, itemsize)


def test_wrapper_takes_plain_version_on_cpu():
    args = make_args(seed=12)
    before = tsam.lstm_sample.launches
    a = run_port(args, [1, 2], fn=tsam.lstm_sample, max_len=6, greedy=False)
    b = run_port(args, [1, 2], max_len=6, greedy=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tsam.lstm_sample.launches == before


@pytest.mark.parametrize("greedy", [True, False])
def test_bf16_relaxed_serving_tier_vs_jax(greedy):
    """bfloat16 operands, same seed words: row match >= the reference's
    relaxed-serving floor, summed log-prob rtol <= its bound."""
    args = make_args(B=16, H=32, E=32, V=600, seed=20)
    f32 = ("gx_static", "b_out")
    kw = dict(max_len=10, greedy=greedy)
    j = jps.lstm_sample_scan(*(
        jnp.asarray(v, jnp.float32 if k in f32 else jnp.bfloat16)
        for k, v in args.items()), jnp.asarray([5, 6], jnp.int32), **kw)
    p = tsam.lstm_sample_ref(*(
        torch.from_numpy(v).to(torch.float32 if k in f32 else torch.bfloat16)
        for k, v in args.items()), (5, 6), **kw)
    same = (np.asarray(j[0]) == p[0].numpy()).all(-1)
    assert same.mean() >= RELAXED_SERVING_MATCH_FLOOR
    js = np.asarray(j[1]).sum(-1)[same]
    ps = p[1].numpy().sum(-1)[same]
    assert (np.abs(js - ps) / np.abs(js)).max() <= RELAXED_SERVING_SCORE_RTOL


@pytest.mark.parametrize("seed", [20, 21, 22])
@pytest.mark.parametrize("greedy", [True, False])
def test_f16_tier_vs_jax(greedy, seed):
    """float16 operands, same seed words, against the JAX twin at
    float16 (module docstring's tier)."""
    args = make_args(B=16, H=32, E=32, V=600, seed=seed)
    f32 = ("gx_static", "b_out")
    kw = dict(max_len=10, greedy=greedy)
    j = jps.lstm_sample_scan(*(
        jnp.asarray(v, jnp.float32 if k in f32 else jnp.float16)
        for k, v in args.items()), jnp.asarray([5, 6], jnp.int32), **kw)
    p = tsam.lstm_sample_ref(*(
        torch.from_numpy(v).to(torch.float32 if k in f32 else torch.float16)
        for k, v in args.items()), (5, 6), **kw)
    same = (np.asarray(j[0]) == p[0].numpy()).all(-1)
    assert same.mean() >= F16_MATCH_FLOOR
    np.testing.assert_array_equal(p[2].numpy()[same], np.asarray(j[2])[same])
    js = np.asarray(j[1]).sum(-1)[same]
    ps = p[1].numpy().sum(-1)[same]
    assert (np.abs(js - ps) / np.abs(js)).max() <= F16_SCORE_RTOL


@pytest.mark.parametrize("B,F,A,E,H", [
    (64, 0, 0, 512, 512), (320, 0, 0, 512, 512), (1280, 0, 0, 512, 512),
    (64, 56, 512, 512, 512), (8, 0, 0, 32, 32), (48, 5, 32, 16, 16),
])
def test_f16_stream_geometry_is_bf16s(B, F, A, E, H):
    """The float16 call's (bt, V_pad) is the bfloat16 call's and the
    reference picker's at float16 (itemsize 2 for both)."""
    V = 10_496
    got = tsam.stream_geometry(B, E, H, torch.float16, V, F, A)
    assert got == tsam.stream_geometry(B, E, H, torch.bfloat16, V, F, A)
    bt, Vt = jps._pick_tiles(B, F, A, E, H, jnp.dtype(jnp.float16).itemsize)
    assert got == (bt, -(-V // Vt) * Vt)
    assert dc.KERNEL_DTYPES[torch.float16] == 2
    assert torch.float16 in dc.TC_DTYPES
