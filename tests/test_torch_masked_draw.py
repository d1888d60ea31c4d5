"""Masked vocab columns take no Gumbel draw in the multinomial samplers.

The hash-Gumbel draw ``-log(-log(u))`` is +inf when ``u`` rounds to 1.0
in float32 (``bits >> 8 = 2^24 - 1``, the reference's stream too), and a
masked column (``decode_bias``'s -1e30: PAD, BOS, a suppressed UNK, the
kernel's padding past V) plus +inf would win the Gumbel-max.  The seeds
here are built so that draw lands on a chosen column at row 0, step 0.
The kernel's padded columns are held on the card (``chip_smoke.py``
5b); here the plain versions on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops.pallas_sampler import _gumbel_from_counter
from cst_captioning_torch.constants import BOS_ID, PAD_ID, UNK_ID
from cst_captioning_torch.ops.decode_common import (
    MASK32,
    fmix32_inverse,
    gumbel_from_counter,
    seed_for_inf_draw,
)
from cst_captioning_torch.ops.sampler import attlstm_sample_ref, lstm_sample_ref

def _fmix32(z: int) -> int:
    z ^= z >> 16
    z = (z * 0x85EBCA6B) & MASK32
    z ^= z >> 13
    z = (z * 0xC2B2AE35) & MASK32
    return z ^ (z >> 16)


def test_the_inverse_and_the_inf_draw():
    for z in (0, 1, 0xDEADBEEF, 0xFFFFFFFF, 12345678):
        assert _fmix32(fmix32_inverse(z)) == z
    _, s1 = seed_for_inf_draw(0)
    word = _fmix32(s1)
    # Both streams give +inf there: u = (2^24 - 1) * 2^-24 + 2^-25
    # rounds to 1.0 in float32.
    g = gumbel_from_counter(torch.tensor([0]), torch.tensor([word]))
    assert torch.isinf(g).all() and (g > 0).all()
    assert np.isposinf(np.asarray(_gumbel_from_counter(
        jnp.uint32(0), jnp.uint32(word))))


def _operands(V, E=8, H=8, B=2, seed=0, attention=False):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3  # noqa: E731
    ops = [r(B, 4 * H), r(E, 4 * H), r(H, 4 * H)]
    if attention:
        F, A = 3, 8
        ops += [r(E, 4 * H), r(H, A), r(A, 1), r(B, F, A),
                torch.ones(B, F), r(B, F, E)]
    return ops + [r(V, E), r(H, V), r(V)]


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("col,suppress", [(PAD_ID, False), (BOS_ID, False),
                                          (UNK_ID, True)])
def test_masked_column_never_drawn(attention, col, suppress):
    V = 40
    ops = _operands(V, attention=attention)
    fn = attlstm_sample_ref if attention else lstm_sample_ref
    seed = seed_for_inf_draw(col)
    toks, lps, mask = fn(*ops, seed, max_len=3, greedy=False,
                         suppress_unk=suppress)
    assert int(toks[0, 0]) != col
    assert int(toks[0, 0]) not in (PAD_ID, BOS_ID)
    assert float(mask[0, 0]) == 1.0
    assert torch.isfinite(lps).all()
    # An unmasked column with the +inf draw is still drawn.
    free = 7
    toks, _, _ = fn(*ops, seed_for_inf_draw(free), max_len=3, greedy=False,
                    suppress_unk=suppress)
    assert int(toks[0, 0]) == free
