"""The port's threefry-2x32 streams (``ops/threefry.py``) against
``jax.random`` on the CPU, bitwise: the block function, ``fold_in``,
``split`` and ``bits`` at several keys and shapes, and the Gumbel-max
draw in both stream modes: row-keyed (the reference's own
``decoding/core.py::row_sample_fn`` over 320 rows at V = 10,496, greedy
rows mixed in) and batch (``jax.random.categorical`` on one key).
Tokens exact, log-probs (``log_softmax(scaled)[token]``) within rtol
1e-6 of ``jax.nn.log_softmax``'s (two sums in other orders).
"""

import jax
import jax._src.prng as jprng
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.decoding import core as jcore
from cst_captioning_torch.ops import threefry as tf

SEEDS = (0, 1, 42, 2**31 - 1, 123456789)
V = 10_496


def _kd(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_block_function_bitwise(seed):
    """threefry2x32 on counters with high words set (the 64-bit flat
    counter's hi half), as tensors and as Python ints."""
    key = _kd(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed % 2**31)
    x0 = rng.randint(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    x1 = rng.randint(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    want = jprng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                     jnp.asarray(x0), jnp.asarray(x1))
    got = tf.threefry2x32(key, torch.from_numpy(x0.astype(np.int64)),
                          torch.from_numpy(x1.astype(np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _words(w))
    one = tf.threefry2x32(key, int(x0[3]), int(x1[3]))
    assert one == (int(want[0][3]), int(want[1][3]))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    kd = _kd(key)
    for d in (0, 1, 7, 1000, 2**31 - 1, 2**32 - 1):
        assert tf.fold_in(kd, d) == _kd(jax.random.fold_in(key, d)), d
    rows = np.array([0, 3, 99, 2**31 - 5], np.int64)
    got = tf.fold_in(kd, torch.from_numpy(rows))
    for i, d in enumerate(rows):
        want = _kd(jax.random.fold_in(key, int(d)))
        assert (int(got[0][i]), int(got[1][i])) == want
    for n in (2, 3, 8):
        want = [tuple(int(x) for x in r) for r in
                np.asarray(jax.random.key_data(jax.random.split(key, n)))]
        assert tf.split(kd, n) == want
    # a key given as a tensor of its two words
    assert tf.split(torch.tensor(kd), 2) == tf.split(kd, 2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (17,), (3, 5), (4, 1000), (2, 3, 7)])
def test_bits_bitwise(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = _words(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(tf.random_bits(_kd(key), shape).numpy(), want)


def test_gumbel_bitwise_and_bounded():
    """``jax.random.gumbel``'s uniform from the same bits exactly, its
    noise within 4e-6 (XLA's log and the C library's differ in the last
    bit), and at the extreme bit patterns the noise lies in [-4.48,
    15.95], so a column at -1e30 / T can never win."""
    key = jax.random.PRNGKey(3)
    tiny = np.finfo(np.float32).tiny
    bits = tf.random_bits(_kd(key), (64, 300))
    np.testing.assert_array_equal(
        tf.uniform_from_bits(bits).numpy(),
        np.asarray(jax.random.uniform(key, (64, 300), minval=tiny,
                                      maxval=1.0)))
    np.testing.assert_allclose(tf.gumbel_from_bits(bits).numpy(),
                               np.asarray(jax.random.gumbel(key, (64, 300))),
                               rtol=0, atol=4e-6)
    ext = tf.gumbel_from_bits(torch.tensor([0, 511, 2**32 - 1, 2**31]))
    assert float(ext.min()) >= -4.48 and float(ext.max()) <= 15.95
    assert np.isfinite(ext.numpy()).all()


_FIRST_LOG = r"""
import sys
import numpy as np
import torch
from cst_captioning_torch.ops import threefry as tf
torch.set_num_threads(8)
bits = tf.random_bits((0, int(sys.argv[1])), (64, 4096))
g = tf.gumbel_from_bits(bits).numpy().astype(np.float64)  # first log
u = tf.uniform_from_bits(bits).numpy().astype(np.float64)
print(float(np.abs(g + np.log(-np.log(u))).max()))
"""


def test_gumbel_first_log_of_a_process():
    """The noise is within 4e-6 of the exact Gumbel even when it is the
    process's first log: torch's first parallel CPU log sometimes ran a
    less accurate MKL log on some chunks (1e-4 near u = 1), which
    ``gumbel_from_bits`` now settles with one serial log first.  Four
    fresh processes at 8 threads."""
    import subprocess
    import sys

    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_LOG, str(s)],
                              stdout=subprocess.PIPE, text=True)
             for s in range(4)]
    errs = [float(p.communicate(timeout=300)[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert max(errs) <= 4e-6, errs


def _scaled(G, seed, temperature=0.9, masked=(0, 1)):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(G, V) * 2.0).astype(np.float32)
    lg[:, list(masked)] = -1e30
    lg[::7, 11] = lg[::7].max(axis=1)          # exact ties with the top
    return lg / np.float32(temperature)


@pytest.mark.parametrize("seed", [0, 1])
def test_row_keyed_draw_vs_row_sample_fn(seed):
    """320 rows at V = 10,496, random row ids and decode positions,
    a third of the rows greedy: the port's plain draw vs the reference's
    ``row_sample_fn`` (``vmap(categorical)`` on fold_in keys)."""
    G = 320
    scaled = _scaled(G, seed)
    rng = np.random.RandomState(seed + 10)
    row_id = rng.randint(0, 5000, G).astype(np.int32)
    step = rng.randint(0, 30, G).astype(np.int32)
    is_sample = rng.rand(G) > 0.33
    base = jax.random.PRNGKey(seed + 100)
    st = jcore.CoreState(state=None, seqs=None, scores=None, lps=None,
                         finished=None, tokens=None, step=jnp.asarray(step),
                         rng=None)
    want = np.asarray(jcore.row_sample_fn(
        base, jnp.asarray(row_id), jnp.asarray(is_sample))(
            jnp.asarray(scaled), None, st))
    tok, lp = tf.categorical_ref(
        torch.from_numpy(scaled), base=_kd(base),
        row_id=torch.from_numpy(row_id), step=torch.from_numpy(step),
        is_sample=torch.from_numpy(is_sample))
    np.testing.assert_array_equal(tok.numpy(), want)
    jlp = np.asarray(jax.nn.log_softmax(jnp.asarray(scaled), axis=-1))
    np.testing.assert_allclose(lp.numpy(), jlp[np.arange(G), want], rtol=1e-6)
    assert not np.isin(want, (0, 1)).any()
    # the greedy rows took the argmax, the lowest index on the ties
    np.testing.assert_array_equal(tok.numpy()[~is_sample],
                                  scaled[~is_sample].argmax(axis=1))
    # the wrapper takes the plain version on CPU tensors, uncounted
    before = tf.threefry_sample.launches
    tok2, lp2 = tf.threefry_sample(
        torch.from_numpy(scaled), base=_kd(base),
        row_id=torch.from_numpy(row_id), step=torch.from_numpy(step),
        is_sample=torch.from_numpy(is_sample))
    assert torch.equal(tok2, tok) and torch.equal(lp2, lp)
    assert tf.threefry_sample.launches == before


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("G", [1, 5, 64])
def test_batch_draw_vs_categorical(seed, G):
    """The batch stream (counter g * V + v) vs ``jax.random.categorical``
    on one key."""
    scaled = _scaled(G, seed, temperature=1.0)
    key = jax.random.PRNGKey(seed + 3)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(scaled)))
    tok, lp = tf.categorical_ref(torch.from_numpy(scaled), key=_kd(key))
    np.testing.assert_array_equal(tok.numpy(), want)
    jlp = np.asarray(jax.nn.log_softmax(jnp.asarray(scaled), axis=-1))
    np.testing.assert_allclose(lp.numpy(), jlp[np.arange(G), want], rtol=1e-6)


def test_refusals():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="either key"):
        tf.categorical_ref(x)
    with pytest.raises(ValueError, match="either key"):
        tf.threefry_sample(x, key=(0, 0), base=(0, 0),
                           row_id=torch.zeros(3), step=torch.zeros(3))
    with pytest.raises(ValueError, match="row_id"):
        tf.categorical_ref(x, base=(1, 2), row_id=torch.zeros(2))
    with pytest.raises(ValueError, match="float32"):
        tf.categorical_ref(x.double(), key=(1, 2))
    with pytest.raises(ValueError, match="is_sample"):
        tf.categorical_ref(x, key=(1, 2), is_sample=torch.ones(2, dtype=bool))
    with pytest.raises(ValueError, match="unsupported device"):
        tf.threefry_sample(x.to("meta"), key=(1, 2))
