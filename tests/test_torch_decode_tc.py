"""The operands that the bf16 decoders' tensor-core chain
(``csrc/decode_tc.cuh``: entries ``cst_lstm_beam_tc`` and
``cst_lstm_sample_tc`` for meanpool fusion, ``cst_attlstm_beam_tc`` and
``cst_attlstm_sample_tc`` for attention) reads, as the wrappers stage
them in PyTorch, against what the plain versions and the JAX package
stage; and the chain's shape gate.  No card is needed: the staging is
plain PyTorch and the gate raises before any launch.

* the B^T layouts ``[W_x ; W_ctx ; W_h]^T`` (meanpool ``[W_x ;
  W_h]^T``), ``att_wh^T`` and ``W_out^T``: bitwise the plain version's
  operands rounded to bf16 (``rnn.dot_f32``), transposed; under int8w the
  codes widened to bf16, bitwise the JAX ``quant_matmul``'s
  ``q.astype(x.dtype)``;
* the int8w embedding table: every row bitwise the plain version's
  ``dequant_rows`` of that row and the JAX ``dequant_rows``;
* the bf16 ``h`` state: every product that reads ``h`` in the plain
  versions (the query, the gate and vocab products, and through them
  the attention context) gives the same bits from ``h`` and from ``h``
  rounded to bf16, so the chain may keep ``h`` in bf16; the meanpool
  plain decoders give bitwise the same outputs with ``h`` so kept;
* the gate: E or H (or A under attention) not a multiple of 32 at bf16
  compute raises ``TensorCoreShapeError`` before the library is loaded,
  for float and int8 weights; float32 compute never meets the gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import quant as jq
from cst_captioning_torch.ops import beam as tbeam
from cst_captioning_torch.ops import decode_common as dc
from cst_captioning_torch.ops import quant as tq
from cst_captioning_torch.ops import sampler as tsam
from cst_captioning_torch.ops.attlstm import attention_step
from cst_captioning_torch.ops.rnn import dot_f32

BF = torch.bfloat16


def make(E=32, H=64, A=32, F=5, V=300, B=4, seed=0):
    """A decoder's operands as float32 tensors, from a numpy seed."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=0.3: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * sc).astype(np.float32))
    mask = torch.from_numpy((rng.rand(B, F) > 0.2).astype(np.float32))
    mask[:, 0] = 1.0
    return dict(gx_static=f(B, 4 * H, sc=0.1), w_x=f(E, 4 * H),
                wh=f(H, 4 * H), w_ctx=f(E, 4 * H), att_wh=f(H, A),
                att_v=f(A, 1), att_proj=f(B, F, A), att_mask=mask,
                att_vals=f(B, F, E), emb=f(V, E), w_out=f(H, V),
                b_out=f(V, sc=0.1))


def quantized(a):
    """``a`` with its weights as int8 codes (``quantize_per_channel``, as
    the model stores them) and the scales ``(emb, wout, lstm, att)``."""
    lstm_q, lstm_s = tq.quantize_per_channel(
        torch.cat([a["w_x"], a["w_ctx"], a["wh"]]), 1)
    E = a["w_x"].shape[0]
    emb_q, emb_s = tq.quantize_per_channel(a["emb"], 0)
    out_q, out_s = tq.quantize_per_channel(a["w_out"], 1)
    att_q, att_s = tq.quantize_per_channel(a["att_wh"], 1)
    q = dict(a, w_x=lstm_q[:E], w_ctx=lstm_q[E:2 * E], wh=lstm_q[2 * E:],
             emb=emb_q, w_out=out_q, att_wh=att_q)
    return q, (emb_s, out_s, lstm_s, att_s)


def bits(x):
    return x.contiguous().view(torch.int16)


@pytest.mark.parametrize("E,H,A,V", [(32, 64, 32, 300), (64, 32, 96, 128)])
def test_float_weights_staged_as_the_plain_version_rounds_them(E, H, A, V):
    a = make(E=E, H=H, A=A, V=V)
    _, w_out_p = dc.masked_vocab(a["b_out"], a["w_out"], V, V, False, BF)
    table, wcat_t, att_wh_t, w_out_t = dc.stage_tc_weights(
        a["w_x"].to(BF), a["w_ctx"].to(BF), a["wh"].to(BF),
        a["att_wh"].to(BF), a["emb"].to(BF), w_out_p)
    assert wcat_t.shape == (4 * H, 2 * E + H) and wcat_t.is_contiguous()
    assert att_wh_t.shape == (A, H) and w_out_t.shape == (V, H)
    for got, w in ((wcat_t[:, :E], a["w_x"]), (wcat_t[:, E:2 * E], a["w_ctx"]),
                   (wcat_t[:, 2 * E:], a["wh"]), (att_wh_t, a["att_wh"]),
                   (w_out_t, a["w_out"]), (table.t(), a["emb"])):
        assert got.dtype == BF
        assert torch.equal(bits(got.t()), bits(w.to(BF)))


def test_staged_products_are_the_plain_products():
    """The tile GEMM's product A @ (B^T)^T on the staged operands, summed
    exactly (float64), equals the plain version's operands' product
    summed exactly: the layout maps every weight to its column."""
    E, H, A, V = 32, 64, 32, 300
    a = make(E=E, H=H, A=A, V=V)
    w16 = {k: a[k].to(BF) for k in ("w_x", "w_ctx", "wh", "att_wh", "emb")}
    table, wcat_t, att_wh_t, w_out_t = dc.stage_tc_weights(
        w16["w_x"], w16["w_ctx"], w16["wh"], w16["att_wh"], w16["emb"],
        a["w_out"].to(BF))
    rng = np.random.RandomState(3)
    tok = torch.from_numpy(rng.randint(0, V, size=7))
    ctx = torch.from_numpy(rng.randn(7, E).astype(np.float32)).to(BF)
    h = torch.from_numpy(rng.randn(7, H).astype(np.float32)).to(BF)
    x = torch.cat([table[tok], ctx, h], 1).double()
    want = torch.cat([w16["w_x"], w16["w_ctx"], w16["wh"]]).double()
    assert torch.equal(x @ wcat_t.double().t(), x @ want)
    assert torch.equal(h.double() @ att_wh_t.double().t(),
                       h.double() @ w16["att_wh"].double())
    assert torch.equal(h.double() @ w_out_t.double().t(),
                       h.double() @ a["w_out"].to(BF).double())


@pytest.mark.parametrize("V", [300, 1100])
def test_int8_codes_widened_exactly_and_table_is_dequant_rows(V):
    E, H, A = 32, 64, 32
    qa, (emb_s, out_s, lstm_s, att_s) = quantized(make(E=E, H=H, A=A, V=V))
    Vp = -(-V // dc.KERNEL_TILE_V) * dc.KERNEL_TILE_V
    _, w_out_p, _ = dc.masked_vocab_q(qa["b_out"], qa["w_out"], out_s, V, Vp,
                                      False)
    table, wcat_t, att_wh_t, w_out_t = dc.stage_tc_weights(
        qa["w_x"], qa["w_ctx"], qa["wh"], qa["att_wh"], qa["emb"], w_out_p,
        emb_s)
    codes = torch.cat([qa["w_x"], qa["w_ctx"], qa["wh"]])
    for got, q in ((wcat_t, codes), (att_wh_t, qa["att_wh"]),
                   (w_out_t, w_out_p)):
        assert got.dtype == BF
        assert torch.equal(got.t().float(), q.float())  # exact widening
        jwide = np.asarray(jnp.asarray(q.numpy()).astype(jnp.bfloat16)
                           .astype(jnp.float32))
        assert np.array_equal(got.t().float().numpy(), jwide)
    ids = torch.arange(V)
    assert torch.equal(bits(table), bits(tq.dequant_rows(qa["emb"], emb_s,
                                                         ids, BF)))
    jrows = jq.dequant_rows(jnp.asarray(qa["emb"].numpy()),
                            jnp.asarray(emb_s.numpy()),
                            jnp.asarray(ids.numpy()), jnp.bfloat16)
    assert np.array_equal(table.float().numpy(),
                          np.asarray(jrows.astype(jnp.float32)))


@pytest.mark.parametrize("quant", [False, True])
def test_h_kept_in_bf16_is_exact(quant):
    """Every plain product that reads h rounds it to bf16 first, so h and
    T(h) give the same bits: the query (and the context it leads to), the
    gate product and the vocab logits."""
    E, H, A = 32, 64, 32
    a = make(E=E, H=H, A=A)
    scales = (None, None, None, None)
    if quant:
        a, scales = quantized(a)
    _, out_s, ls, att_s = scales
    rng = np.random.RandomState(5)
    h = torch.from_numpy(rng.randn(a["gx_static"].shape[0], H)
                         .astype(np.float32) * 0.4)
    h16 = h.to(BF).float()
    assert not torch.equal(h, h16)
    w = {k: (a[k] if quant else a[k].to(BF)) for k in ("wh", "att_wh",
                                                       "w_out")}
    for wk, s in (("wh", ls), ("att_wh", att_s), ("w_out", out_s)):
        assert torch.equal(dot_f32(h, w[wk], BF, s), dot_f32(h16, w[wk], BF, s))
    args = (w["att_wh"], a["att_v"].float()[:, 0], a["att_proj"].to(BF),
            a["att_mask"], a["att_vals"].to(BF).float(), BF, att_s)
    for x, y in zip(attention_step(h, *args), attention_step(h16, *args)):
        assert torch.equal(x, y)


def _call(mod, a, quant=None, cdt=None):
    args = [a[k] for k in ("gx_static", "w_x", "wh", "w_ctx", "att_wh",
                           "att_v", "att_proj", "att_mask", "att_vals",
                           "emb", "w_out", "b_out")]
    if mod is tbeam:
        return tbeam._launch("attlstm_beam", args[0], args[1], args[2],
                             tuple(args[3:9]), *args[9:], 2, 4, False, quant,
                             cdt)
    return tsam._launch("attlstm_sample", args[0], args[1], args[2],
                        tuple(args[3:9]), *args[9:], (1, 2), 4, True, 1.0,
                        False, quant, cdt)


def _to(a, cdt):
    return {k: (v if k in ("gx_static", "b_out", "att_mask")
                or v.dtype == torch.int8 else v.to(cdt))
            for k, v in a.items()}


@pytest.fixture
def no_library(monkeypatch):
    """Fail if a wrapper reaches for the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(tbeam, "_bound", refuse)
    monkeypatch.setattr(tsam, "_bound", refuse)


@pytest.mark.parametrize("mod", [tbeam, tsam], ids=["beam", "sample"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8w"])
@pytest.mark.parametrize("E,H,A", [(48, 64, 32), (32, 40, 32), (32, 64, 24),
                                   (16, 16, 16)])
def test_bf16_width_gate_raises_named_error(mod, quant, E, H, A, no_library):
    a = make(E=E, H=H, A=A)
    if quant:
        qa, scales = quantized(a)
        with pytest.raises(dc.TensorCoreShapeError, match="multiples of 32"):
            _call(mod, _to(qa, BF), scales, BF)
    else:
        with pytest.raises(dc.TensorCoreShapeError, match="multiples of 32"):
            _call(mod, _to(a, BF))


@pytest.mark.parametrize("mod", [tbeam, tsam], ids=["beam", "sample"])
def test_gate_passes_good_widths_and_f32_never_meets_it(mod, no_library):
    """Widths the chain takes pass the gate (the CPU tensor is then
    refused as a device); float32 compute keeps its SIMT kernels, which
    take any width."""
    with pytest.raises(ValueError, match="unsupported device") as err:
        _call(mod, _to(make(E=32, H=64, A=32), BF))
    assert not isinstance(err.value, dc.TensorCoreShapeError)
    with pytest.raises(ValueError, match="unsupported device") as err:
        _call(mod, make(E=48, H=40, A=24))
    assert not isinstance(err.value, dc.TensorCoreShapeError)


# ------------------------------------------------------------ meanpool

MP_KEYS = ("gx_static", "w_x", "wh", "emb", "w_out", "b_out")


def quantized_mp(a):
    """The meanpool operands of ``a`` with int8 weight codes as the
    model stores them (one (4H,) scale over the stacked [W_x ; W_h]) and
    the scales ``(emb, wout, lstm)``."""
    E = a["w_x"].shape[0]
    lstm_q, lstm_s = tq.quantize_per_channel(torch.cat([a["w_x"], a["wh"]]),
                                             1)
    emb_q, emb_s = tq.quantize_per_channel(a["emb"], 0)
    out_q, out_s = tq.quantize_per_channel(a["w_out"], 1)
    q = dict(a, w_x=lstm_q[:E], wh=lstm_q[E:], emb=emb_q, w_out=out_q)
    return q, (emb_s, out_s, lstm_s)


@pytest.mark.parametrize("E,H,V", [(32, 64, 300), (64, 32, 128)])
def test_meanpool_weights_staged_as_the_plain_version_rounds_them(E, H, V):
    a = make(E=E, H=H, V=V)
    _, w_out_p = dc.masked_vocab(a["b_out"], a["w_out"], V, V, False, BF)
    table, wcat_t, att_wh_t, w_out_t = dc.stage_tc_weights(
        a["w_x"].to(BF), None, a["wh"].to(BF), None, a["emb"].to(BF),
        w_out_p)
    assert att_wh_t is None
    assert wcat_t.shape == (4 * H, E + H) and wcat_t.is_contiguous()
    assert w_out_t.shape == (V, H) and w_out_t.is_contiguous()
    for got, w in ((wcat_t[:, :E], a["w_x"]), (wcat_t[:, E:], a["wh"]),
                   (w_out_t, a["w_out"]), (table.t(), a["emb"])):
        assert got.dtype == BF
        assert torch.equal(bits(got.t()), bits(w.to(BF)))


def test_meanpool_staged_products_are_the_plain_products():
    """The meanpool gate operand [emb(tok) | T(h)] against the staged
    ``[W_x ; W_h]^T``, and h against ``W_out^T``, summed exactly
    (float64): the plain version's two products, summed exactly."""
    E, H, V = 32, 64, 300
    a = make(E=E, H=H, V=V)
    w16 = {k: a[k].to(BF) for k in ("w_x", "wh", "emb", "w_out")}
    table, wcat_t, _, w_out_t = dc.stage_tc_weights(
        w16["w_x"], None, w16["wh"], None, w16["emb"], w16["w_out"])
    rng = np.random.RandomState(4)
    tok = torch.from_numpy(rng.randint(0, V, size=9))
    h = torch.from_numpy(rng.randn(9, H).astype(np.float32)).to(BF)
    x = torch.cat([table[tok], h], 1).double()
    want = (w16["emb"][tok].double() @ w16["w_x"].double()
            + h.double() @ w16["wh"].double())
    assert torch.equal(x @ wcat_t.double().t(), want)
    assert torch.equal(h.double() @ w_out_t.double().t(),
                       h.double() @ w16["w_out"].double())


@pytest.mark.parametrize("V", [300, 1100])
def test_meanpool_int8_codes_widened_exactly_and_table_is_dequant_rows(V):
    E, H = 32, 64
    qa, (emb_s, out_s, lstm_s) = quantized_mp(make(E=E, H=H, V=V))
    Vp = -(-V // dc.KERNEL_TILE_V) * dc.KERNEL_TILE_V
    _, w_out_p, _ = dc.masked_vocab_q(qa["b_out"], qa["w_out"], out_s, V, Vp,
                                      False)
    table, wcat_t, att_wh_t, w_out_t = dc.stage_tc_weights(
        qa["w_x"], None, qa["wh"], None, qa["emb"], w_out_p, emb_s)
    assert att_wh_t is None and wcat_t.shape == (4 * H, E + H)
    for got, q in ((wcat_t, torch.cat([qa["w_x"], qa["wh"]])),
                   (w_out_t, w_out_p)):
        assert got.dtype == BF
        assert torch.equal(got.t().float(), q.float())  # exact widening
        jwide = np.asarray(jnp.asarray(q.numpy()).astype(jnp.bfloat16)
                           .astype(jnp.float32))
        assert np.array_equal(got.t().float().numpy(), jwide)
    ids = torch.arange(V)
    assert torch.equal(bits(table), bits(tq.dequant_rows(qa["emb"], emb_s,
                                                         ids, BF)))
    jrows = jq.dequant_rows(jnp.asarray(qa["emb"].numpy()),
                            jnp.asarray(emb_s.numpy()),
                            jnp.asarray(ids.numpy()), jnp.bfloat16)
    assert np.array_equal(table.float().numpy(),
                          np.asarray(jrows.astype(jnp.float32)))


@pytest.mark.parametrize("mod", [tbeam, tsam], ids=["beam", "sample"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8w"])
def test_h_kept_in_bf16_is_exact_in_the_meanpool_decoders(mod, quant,
                                                          monkeypatch):
    """The meanpool plain decoders read h only through the gate and vocab
    products (``wh``, ``w_out``), each rounding it to bf16 first: with
    every new h rounded to bf16 as the chain keeps it, their outputs are
    bitwise the same."""
    a = make(E=32, H=64, V=300, B=5)
    kw = {}
    if quant:
        a, scales = quantized_mp(a)
        kw = dict(quant=scales, compute_dtype=BF)
    args = [a[k] if a[k].dtype == torch.int8
            or k in ("gx_static", "b_out") else a[k].to(BF) for k in MP_KEYS]

    def run():
        if mod is tbeam:
            return [tbeam.lstm_beam_ref(*args, beam_size=3, max_len=6, **kw)]
        return [tsam.lstm_sample_ref(*args, (3, 4), max_len=6, greedy=g, **kw)
                for g in (True, False)]

    want = run()
    real = mod.gate_update

    def rounded(gates, c):
        h, c = real(gates, c)
        return h.to(BF).float(), c

    monkeypatch.setattr(mod, "gate_update", rounded)
    got = run()
    for x, y in zip(sum(map(list, got), []), sum(map(list, want), [])):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _call_mp(mod, a, quant=None, cdt=None):
    args = [a[k] for k in MP_KEYS]
    if mod is tbeam:
        return tbeam._launch("lstm_beam", args[0], args[1], args[2], None,
                             *args[3:], 2, 4, False, quant, cdt)
    return tsam._launch("lstm_sample", args[0], args[1], args[2], None,
                        *args[3:], (1, 2), 4, True, 1.0, False, quant, cdt)


@pytest.mark.parametrize("mod", [tbeam, tsam], ids=["beam", "sample"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8w"])
@pytest.mark.parametrize("E,H", [(48, 64), (32, 40), (16, 16)])
def test_meanpool_bf16_width_gate_raises_named_error(mod, quant, E, H,
                                                     no_library):
    a = make(E=E, H=H)
    if quant:
        qa, scales = quantized_mp(a)
        with pytest.raises(dc.TensorCoreShapeError,
                           match="E and H in multiples of 32"):
            _call_mp(mod, _to(qa, BF), scales, BF)
    else:
        with pytest.raises(dc.TensorCoreShapeError,
                           match="E and H in multiples of 32"):
            _call_mp(mod, _to(a, BF))


@pytest.mark.parametrize("mod", [tbeam, tsam], ids=["beam", "sample"])
def test_meanpool_gate_passes_good_widths_and_f32_never_meets_it(mod,
                                                                 no_library):
    """Meanpool widths the chain takes pass the gate (the CPU tensor is
    then refused as a device), with no attention width asked for;
    float32 compute, float or int8 weights, keeps its SIMT kernels, which
    take any width."""
    for a, q in ((_to(make(E=32, H=64, A=8), BF), None),
                 (make(E=48, H=40), None)):
        with pytest.raises(ValueError, match="unsupported device") as err:
            _call_mp(mod, a, q)
        assert not isinstance(err.value, dc.TensorCoreShapeError)
    qa, scales = quantized_mp(make(E=48, H=40))
    with pytest.raises(ValueError, match="unsupported device") as err:
        _call_mp(mod, qa, scales, torch.float32)
    assert not isinstance(err.value, dc.TensorCoreShapeError)
