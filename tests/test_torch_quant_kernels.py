"""The plain int8w versions of the port's six int8w kernels against the
JAX package's twins and its Pallas kernels in interpret mode, on the
same numpy weights quantized by the JAX ``quantize_per_channel`` (codes
and scales handed to both sides).

* the four decoders (``lstm_beam`` / ``attlstm_beam`` /
  ``lstm_sample`` / ``attlstm_sample`` with ``quant=``): tokens (and the
  sampler's mask) exact at float32 and bfloat16 compute, including V =
  1100 (several streamed int8 vocab tiles and a padded tail: no token in
  the padding); beam scores and sampler log-probs within rtol 1e-5 at
  float32 (float32 products summed in another library's order) and 1e-3
  at bfloat16 (the attention context is summed over frames in float32 in
  another order than XLA's, and its rounding to bfloat16 can then land
  one bf16 ulp apart: 1.2e-4 read on the all-masked row);
* the two recurrences (``lstm_recurrence_quant``,
  ``attlstm_recurrence_quant``): ``h_seq`` within rtol 1e-5 / atol 1e-6
  at float32 and within one bf16 ulp (rtol 2**-7) at bfloat16 — the
  float recurrences' tiers (tests/test_torch_lstm.py,
  tests/test_torch_attlstm.py): the float32 products are summed in
  another order by torch's CPU matmul than by XLA's;
* ``masked_vocab_q``: bit-exact against the reference's
  ``_masked_vocab_q``.

B is a multiple of 8 so the Pallas shape gates admit the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import pallas_attlstm as jpa
from cst_captioning_tpu.ops import pallas_beam as jpb
from cst_captioning_tpu.ops import pallas_lstm as jpl
from cst_captioning_tpu.ops import pallas_sampler as jps
from cst_captioning_tpu.ops import quant as jq
from cst_captioning_torch.ops import attlstm as tatt
from cst_captioning_torch.ops import beam as tbeam
from cst_captioning_torch.ops import decode_common as dc
from cst_captioning_torch.ops import lstm as tlstm
from cst_captioning_torch.ops import sampler as tsam

LP_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
REC_F32 = dict(rtol=1e-5, atol=1e-6)
REC_BF16 = dict(rtol=2.0 ** -7, atol=1e-6)
CDTS = ("float32", "bfloat16")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_args(B=8, H=16, A=16, E=16, F=5, V=50, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=0.3: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    mask = (rng.rand(B, F) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1] = 0.0
    return dict(
        gx_static=f(B, 4 * H, sc=0.1), w_x=f(E, 4 * H), wh=f(H, 4 * H),
        w_ctx=f(E, 4 * H), att_wh=f(H, A), att_v=f(A, 1),
        att_proj=f(B, F, A), att_mask=mask, att_vals=f(B, F, E),
        emb=f(V, E), w_out=f(H, V), b_out=f(V, sc=0.1),
    )


def quantize(args, cdt, attention=True):
    """The model's layout: emb per row, w_out per column, one (4H,)
    scale over the stacked gate rows [w_x | w_ctx | wh], att_wh per
    column; the float attention tensors cast to ``cdt`` (numpy,
    bfloat16 through jnp).  Returns (args, quant tuple) as numpy."""
    q = dict(args)
    q["emb"], es = jq.quantize_per_channel(args["emb"], 0)
    q["w_out"], ws = jq.quantize_per_channel(args["w_out"], 1)
    parts = ["w_x", "w_ctx", "wh"] if attention else ["w_x", "wh"]
    cat_q, ls = jq.quantize_per_channel(
        np.concatenate([args[p] for p in parts], 0), 1)
    r = 0
    for p in parts:
        n = args[p].shape[0]
        q[p] = cat_q[r:r + n]
        r += n
    quant = (es, ws, ls)
    if attention:
        q["att_wh"], asc = jq.quantize_per_channel(args["att_wh"], 1)
        quant += (asc,)
        for p in ("att_v", "att_proj", "att_vals"):
            q[p] = jnp.asarray(args[p]).astype(cdt)
    else:
        q = {k: v for k, v in q.items()
             if not k.startswith("att") and k != "w_ctx"}
    return ({k: np.asarray(v) if v.dtype != jnp.bfloat16 else v
             for k, v in q.items()},
            tuple(np.asarray(x) for x in quant))


def to_torch(x, cdt):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(TDT[cdt])


def run_jax(fn, qa, quant, *extra, cdt, **kw):
    out = fn(*(jnp.asarray(v) for v in qa.values()), *extra,
             quant=tuple(jnp.asarray(x) for x in quant), compute_dtype=cdt,
             **kw)
    return tuple(np.asarray(x) for x in out)


def run_port(fn, qa, quant, *extra, cdt, **kw):
    out = fn(*(to_torch(v, cdt) for v in qa.values()), *extra,
             quant=tuple(torch.from_numpy(np.array(x)) for x in quant),
             compute_dtype=TDT[cdt], **kw)
    return tuple(x.numpy() for x in out)


def assert_sample(j, p, cdt):
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_array_equal(p[2], j[2])
    np.testing.assert_allclose(p[1], j[1], rtol=LP_RTOL[cdt], atol=1e-6)


def assert_beam(j, p, cdt):
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_allclose(p[1], j[1], rtol=LP_RTOL[cdt], atol=1e-6)


# ------------------------------------------------------------ decoders

@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("greedy", [True, False])
def test_sample_ref_matches_jax_twin(cdt, attention, greedy):
    qa, quant = quantize(make_args(seed=2), cdt, attention)
    kw = dict(cdt=cdt, max_len=10, greedy=greedy)
    jfn = jps.attlstm_sample_scan if attention else jps.lstm_sample_scan
    tfn = tsam.attlstm_sample_ref if attention else tsam.lstm_sample_ref
    assert_sample(run_jax(jfn, qa, quant, 7, **kw),
                  run_port(tfn, qa, quant, 7, **kw), cdt)


@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("attention", [True, False])
def test_sample_ref_matches_pallas_kernel_interpret(cdt, attention):
    qa, quant = quantize(make_args(seed=3), cdt, attention)
    kw = dict(cdt=cdt, max_len=8, greedy=False)
    jfn = jps.attlstm_sample if attention else jps.lstm_sample
    tfn = tsam.attlstm_sample if attention else tsam.lstm_sample
    assert_sample(run_jax(jfn, qa, quant, 11, **kw),
                  run_port(tfn, qa, quant, 11, **kw), cdt)


@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("beam_size", [1, 3])
def test_beam_ref_matches_jax_twin(cdt, attention, beam_size):
    qa, quant = quantize(make_args(seed=4), cdt, attention)
    kw = dict(cdt=cdt, beam_size=beam_size, max_len=8)
    jfn = jpb.attlstm_beam_scan if attention else jpb.lstm_beam_scan
    tfn = tbeam.attlstm_beam_ref if attention else tbeam.lstm_beam_ref
    assert_beam(run_jax(jfn, qa, quant, **kw), run_port(tfn, qa, quant, **kw),
                cdt)


@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("attention", [True, False])
def test_beam_ref_matches_pallas_kernel_interpret(cdt, attention):
    qa, quant = quantize(make_args(seed=5), cdt, attention)
    kw = dict(cdt=cdt, beam_size=3, max_len=6)
    jfn = jpb.attlstm_beam if attention else jpb.lstm_beam
    tfn = tbeam.attlstm_beam if attention else tbeam.lstm_beam
    assert_beam(run_jax(jfn, qa, quant, **kw), run_port(tfn, qa, quant, **kw),
                cdt)


@pytest.mark.parametrize("cdt", CDTS)
def test_multi_tile_vocab_with_padded_tail(cdt):
    """V = 1100: several streamed int8 tiles and a padded tail (zero
    codes, unit scales); tokens match the twins and never land in the
    padding."""
    qa, quant = quantize(make_args(V=1100, seed=6), cdt)
    for greedy in (True, False):
        kw = dict(cdt=cdt, max_len=6, greedy=greedy)
        j = run_jax(jps.attlstm_sample_scan, qa, quant, 3, **kw)
        p = run_port(tsam.attlstm_sample_ref, qa, quant, 3, **kw)
        assert_sample(j, p, cdt)
        assert p[0].max() < 1100
    kw = dict(cdt=cdt, beam_size=3, max_len=6)
    j = run_jax(jpb.attlstm_beam_scan, qa, quant, **kw)
    p = run_port(tbeam.attlstm_beam_ref, qa, quant, **kw)
    assert_beam(j, p, cdt)
    assert p[0].max() < 1100


def test_masked_vocab_q_matches_reference():
    rng = np.random.RandomState(0)
    w = rng.randn(8, 130).astype(np.float32)
    q, s = jq.quantize_per_channel(w, 1)
    b = rng.randn(130).astype(np.float32)
    for v_pad, unk in ((130, False), (256, True)):
        jb, jw, js = jps._masked_vocab_q(jnp.asarray(b), q, s, 130, v_pad,
                                         unk)
        tb, tw, ts = dc.masked_vocab_q(
            torch.from_numpy(b), torch.from_numpy(np.asarray(q)),
            torch.from_numpy(np.asarray(s)), 130, v_pad, unk)
        assert tw.dtype == torch.int8
        for t, j in ((tb, jb), (tw, jw), (ts, js)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_int8_weights_never_reach_the_stream_geometry():
    """The picker sizes on the compute dtype's itemsize, so the int8w
    stream is the float one's (reference ``_sample_impl``)."""
    for cdt in (torch.float32, torch.bfloat16):
        assert tsam.stream_geometry(8, 16, 16, cdt, 1100, 5, 16) == \
            tuple(jps._pick_tiles(8, 5, 16, 16, 16, cdt.itemsize)[:1]) + (
                -(-1100 // jps._pick_tiles(8, 5, 16, 16, 16,
                                           cdt.itemsize)[1])
                * jps._pick_tiles(8, 5, 16, 16, 16, cdt.itemsize)[1],)
    with pytest.raises(ValueError, match="compute_dtype"):
        dc.unpack_quant((None,) * 3, None, torch.zeros(1))


# ---------------------------------------------------------- recurrences

def _assert_rec(t, j, cdt):
    tol = REC_F32 if cdt == "float32" else REC_BF16
    assert t.dtype == TDT[cdt]
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("cdt", CDTS)
def test_lstm_recurrence_quant_matches_twin_and_kernel(cdt):
    rng = np.random.RandomState(5)
    R, T, H = 8, 12, 16
    gx = (rng.randn(R, T, 4 * H) * 0.3).astype(np.float32)
    wq, ws = jq.quantize_per_channel(
        (rng.randn(H, 4 * H) * 0.3).astype(np.float32), 1)
    t = tlstm.lstm_recurrence_quant(
        torch.from_numpy(gx), torch.from_numpy(np.asarray(wq)),
        torch.from_numpy(np.asarray(ws)), TDT[cdt])
    for use_pallas in (False, True):
        j = jpl.lstm_recurrence_quant(jnp.asarray(gx), wq, ws, cdt,
                                      use_pallas=use_pallas)
        _assert_rec(t, j, cdt)


@pytest.mark.parametrize("cdt", CDTS)
def test_attlstm_recurrence_quant_matches_twin_and_kernel(cdt):
    rng = np.random.RandomState(9)
    R, T, H, E, F, A = 8, 10, 16, 16, 5, 16
    gx = (rng.randn(R, T, 4 * H) * 0.3).astype(np.float32)
    qa, (_, _, ls, asc) = quantize(make_args(B=R, H=H, A=A, E=E, F=F,
                                             seed=9), cdt)
    names = ("wh", "w_ctx", "att_wh", "att_v", "att_proj", "att_mask",
             "att_vals")
    jargs = (jnp.asarray(gx), qa["wh"], qa["w_ctx"], ls, qa["att_wh"], asc,
             *(jnp.asarray(qa[n]) for n in names[3:]), cdt)
    t = tatt.attlstm_recurrence_quant(
        torch.from_numpy(gx), *(to_torch(qa[n], cdt) for n in names[:2]),
        torch.from_numpy(ls), to_torch(qa["att_wh"], cdt),
        torch.from_numpy(asc), *(to_torch(qa[n], cdt) for n in names[3:]),
        TDT[cdt])
    _assert_rec(t, jpa.attlstm_scan_quant(*jargs), cdt)
    _assert_rec(t, jpa.attlstm_recurrence_quant(*jargs), cdt)
