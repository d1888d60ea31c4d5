"""The tensor-parallel decode of the port (``decoding/core.py``'s
``make_tp_beam_topk`` / ``make_tp_row_pick`` and ``ops/shard_decode.py``)
against the JAX package's (``tests/test_shard_decode.py``).

Tier: the merge primitives select exactly the reference's flat keys and
tokens, engineered exact ties across the shard boundary included;
scores within 1e-6 (the folded normalizer, docs/PARITY.md r15).  The
sharded sampler is token bit-exact against JAX's ``sharded_*_sample``
and its single-device scan twin, greedy and multinomial, both fusions
and int8w; the sharded beam token-exact on duplicate columns across
shards, scores rtol 1e-5.  The JAX side runs on the forced CPU devices
of ``tests/conftest.py``, the port on a mesh of repeated ``cpu``
devices (the kernels' plain versions).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_torch.config import get_preset as tpreset
from cst_captioning_torch.decoding import core as tcore
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.ops import shard_decode as tsd
from cst_captioning_torch.parallel import VocabShardedLogits, make_mesh
from cst_captioning_tpu.constants import PAD_ID
from cst_captioning_tpu.decoding import core as jcore
from cst_captioning_tpu.ops import pallas_beam as jpb
from cst_captioning_tpu.ops import pallas_sampler as jps
from cst_captioning_tpu.ops import quant as jquant
from cst_captioning_tpu.ops import shard_decode as jsd
from cst_captioning_tpu.parallel import make_mesh as jmake_mesh

G, K, V = 3, 4, 40
M = 2


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh({"data": 1, "model": M}, devices=jax.devices()[:M])


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh({"data": 1, "model": M}, devices=["cpu"] * M)


def _sharded(lg: np.ndarray) -> VocabShardedLogits:
    t = torch.from_numpy(lg)
    return VocabShardedLogits(list(t.chunk(M, dim=-1)), "cpu")


def _jst(scores, finished):
    return jcore.CoreState(
        state=None, seqs=jnp.zeros((G, K, 8), jnp.int32),
        scores=jnp.asarray(scores), lps=None,
        finished=jnp.asarray(finished), tokens=None, step=None, rng=None)


def _tst(scores, finished):
    return tcore.CoreState(
        state=None, seqs=torch.zeros((G, K, 8), dtype=torch.int32),
        scores=torch.from_numpy(scores), lps=None,
        finished=torch.from_numpy(finished), tokens=None, step=None)


def _boundary_tie(rng, rows):
    lg = rng.randn(rows, V).astype(np.float32)
    b = V // M
    lg[:, b - 1] = lg[:, b] = np.abs(lg).max() + 1.0
    return lg


# ------------------------------------------------------------ the merges

@pytest.mark.parametrize("case", ["random", "boundary_tie", "finished"])
def test_tp_beam_topk_matches_jax(jmesh, tmesh, case):
    rng = np.random.RandomState({"random": 0, "boundary_tie": 1,
                                 "finished": 2}[case])
    if case == "boundary_tie":
        lg = _boundary_tie(rng, G * K)
        scores = np.zeros((G, K), np.float32)
        fin = np.zeros((G, K), bool)
    else:
        lg = rng.randn(G * K, V).astype(np.float32)
        scores = rng.randn(G, K).astype(np.float32)
        fin = (rng.rand(G, K) < 0.3 if case == "random"
               else np.ones((G, K), bool))
    jtp = jcore.make_tp_beam_topk(jmesh)
    want_sc, want_fl = jax.jit(lambda l: jtp(l, _jst(scores, fin)))(
        jnp.asarray(lg))
    got_sc, got_fl = tcore.make_tp_beam_topk(tmesh)(_sharded(lg),
                                                     _tst(scores, fin))
    np.testing.assert_array_equal(got_fl.numpy(), np.asarray(want_fl))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc),
                               rtol=1e-6, atol=1e-6)
    if case == "boundary_tie":
        fl = got_fl.numpy()
        assert (fl[:, 0] % V == V // M - 1).all()
        np.testing.assert_array_equal(fl[:, 1], fl[:, 0] + 1)


def test_tp_row_pick_matches_jax_and_boundary_tie(jmesh, tmesh):
    lg = _boundary_tie(np.random.RandomState(3), G)
    want_tok, want_lp = jax.jit(jcore.make_tp_row_pick(jmesh))(
        jnp.asarray(lg))
    tok, lp = tcore.make_tp_row_pick(tmesh)(_sharded(lg))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    assert (tok.numpy() == V // M - 1).all()
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-6)


def test_decode_step_hooks_equal_the_gather_path(tmesh):
    """A beam and a greedy step through the hooks equal the same step
    on the gathered logits (``serving.shard_fused_decode = false``)."""
    rng = np.random.RandomState(4)
    lg = rng.randn(G * K, V).astype(np.float32)
    lg[:, V // M - 1] = lg[:, V // M] = np.abs(lg).max() + 1.0
    state = tcore.DecodeState(h=torch.zeros(1, G * K, 2),
                              c=torch.zeros(1, G * K, 2))
    st = tcore.init_core(state, G, K, 6, mode="beam")
    hook = (lambda s, t: (s, _sharded(lg)))  # noqa: E731
    a = tcore.decode_step(hook, st, mode="beam",
                          topk_fn=tcore.make_tp_beam_topk(tmesh))
    b = tcore.decode_step(hook, st, mode="beam")
    assert torch.equal(a.seqs, b.seqs)
    torch.testing.assert_close(a.scores, b.scores, rtol=1e-6, atol=1e-6)
    st1 = tcore.init_core(tcore.DecodeState(h=torch.zeros(1, G, 2),
                                            c=torch.zeros(1, G, 2)),
                          G, 1, 6, mode="greedy")
    hook1 = (lambda s, t: (s, _sharded(lg[:G])))  # noqa: E731
    a = tcore.decode_step(hook1, st1, mode="greedy",
                          pick_fn=tcore.make_tp_row_pick(tmesh))
    b = tcore.decode_step(hook1, st1, mode="greedy")
    assert torch.equal(a.seqs, b.seqs)


# ---------------------------------------------------- the sharded decoders

def _world(rng, B=8, F=3, A=16, E=16, H=16):
    return dict(
        gx=rng.randn(B, 4 * H), w_x=rng.randn(E, 4 * H), wh=rng.randn(H, 4 * H),
        w_ctx=rng.randn(E, 4 * H), att_wh=rng.randn(H, A),
        att_v=rng.randn(A, 1), proj=rng.randn(B, F, A),
        mask=np.ones((B, F)), vals=rng.randn(B, F, E), emb=rng.randn(V, E),
        w_out=rng.randn(H, V), b_out=rng.randn(V))


def _args(w, fusion, conv):
    w = {k: conv(np.asarray(v, np.float32)) for k, v in w.items()}
    if fusion == "attention":
        return (w["gx"], w["w_x"], w["wh"], w["w_ctx"], w["att_wh"],
                w["att_v"], w["proj"], w["mask"], w["vals"], w["emb"],
                w["w_out"], w["b_out"])
    return w["gx"], w["w_x"], w["wh"], w["emb"], w["w_out"], w["b_out"]


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("fusion", ["attention", "meanpool"])
def test_sharded_sampler_bit_exact_vs_jax(jmesh, tmesh, greedy, fusion):
    w = _world(np.random.RandomState(7))
    seed = (123, 456)
    kw = dict(max_len=10, greedy=greedy, temperature=0.8)
    jfn, tfn, scan = (
        (jsd.sharded_attlstm_sample, tsd.sharded_attlstm_sample,
         jps.attlstm_sample_scan) if fusion == "attention" else
        (jsd.sharded_lstm_sample, tsd.sharded_lstm_sample,
         jps.lstm_sample_scan))
    jargs = _args(w, fusion, jnp.asarray) + (jnp.asarray(seed, jnp.int32),)
    want = jfn(*jargs, mesh=jmesh, **kw)
    twin = scan(*jargs, **kw)
    got = tfn(*_args(w, fusion, torch.from_numpy), seed, mesh=tmesh, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(twin[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_sharded_beam_duplicate_columns_across_shards(jmesh, tmesh, fusion):
    """w_out columns V/M - 1 and V/M are identical, so their logits tie
    exactly at every step, one candidate per shard: the port's sharded
    beam emits JAX's sharded beam's (and its scan twin's) tokens."""
    w = _world(np.random.RandomState(11))
    b = V // M
    w["w_out"][:, b] = w["w_out"][:, b - 1]
    w["b_out"][b] = w["b_out"][b - 1] = float(np.abs(w["b_out"]).max()) + 4.0
    kw = dict(beam_size=3, max_len=8)
    jfn, tfn, scan = (
        (jsd.sharded_attlstm_beam, tsd.sharded_attlstm_beam,
         jpb.attlstm_beam_scan) if fusion == "attention" else
        (jsd.sharded_lstm_beam, tsd.sharded_lstm_beam, jpb.lstm_beam_scan))
    jargs = _args(w, fusion, jnp.asarray)
    want_seqs, want_sc = jfn(*jargs, mesh=jmesh, **kw)
    twin_seqs, _ = scan(*jargs, **kw)
    got_seqs, got_sc = tfn(*_args(w, fusion, torch.from_numpy), mesh=tmesh,
                           **kw)
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(twin_seqs))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc),
                               rtol=1e-5, atol=1e-5)
    if fusion == "meanpool":
        assert (got_seqs.numpy() == b - 1).any()


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_sharded_beam_equals_itself_on_one_shard(fusion):
    """The same decoder over one shard holding the whole vocab (no
    merge): tokens exact and scores equal, so a fault in the cross-shard
    merge or the normalizer's fold shows against it (the card's 11a
    holds the sharded ladder the same way)."""
    from cst_captioning_torch.parallel.mesh import row_mesh

    rng = np.random.RandomState(5)
    w = _world(rng, B=16)
    w["w_out"] *= 3.0
    kw = dict(beam_size=5, max_len=12)
    tfn = (tsd.sharded_attlstm_beam if fusion == "attention"
           else tsd.sharded_lstm_beam)
    args = _args(w, fusion, torch.from_numpy)
    one_seqs, one_sc = tfn(*args, mesh=row_mesh(["cpu"]), **kw)
    for m in (2, 4):
        seqs, sc = tfn(*args, mesh=row_mesh(["cpu"] * m), **kw)
        assert torch.equal(seqs, one_seqs), m
        assert torch.equal(sc, one_sc), m


def _quantized(w, fusion):
    """int8 codes and scales of the world's weights by the reference's
    quantizer (absmax), shared by both sides."""
    q = {}
    for name, axis in (("emb", 0), ("w_out", 1), ("w_x", 1), ("wh", 1),
                       ("w_ctx", 1), ("att_wh", 1)):
        codes, scale = jquant.quantize_per_channel(
            jnp.asarray(w[name], jnp.float32), axis=axis)
        q[name] = (np.asarray(codes), np.asarray(scale))
    # The LSTM row blocks share one per-gate-channel scale.
    lstm = np.concatenate([w["w_x"], w["w_ctx"], w["wh"]], 0)
    codes, ls = jquant.quantize_per_channel(jnp.asarray(lstm, jnp.float32),
                                            axis=1)
    codes = np.asarray(codes)
    E = w["w_x"].shape[0]
    q["w_x"] = (codes[:E], None)
    q["w_ctx"] = (codes[E:2 * E], None)
    q["wh"] = (codes[2 * E:], None)
    q["ls"] = np.asarray(ls)
    return q


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_sharded_decoders_int8w(jmesh, tmesh, fusion):
    """int8w: every shard streams its int8 tile with its scale slices;
    greedy and multinomial tokens bit-exact and beam tokens exact vs the
    JAX sharded decoders on the same codes."""
    w = _world(np.random.RandomState(13))
    q = _quantized(w, fusion)
    w8 = dict(w)
    for name in ("emb", "w_out", "w_x", "wh", "w_ctx", "att_wh"):
        w8[name] = q[name][0]

    def args(conv):
        ww = {k: conv(np.array(v, np.int8 if np.asarray(v).dtype == np.int8
                               else np.float32)) for k, v in w8.items()}
        if fusion == "attention":
            return (ww["gx"], ww["w_x"], ww["wh"], ww["w_ctx"], ww["att_wh"],
                    ww["att_v"], ww["proj"], ww["mask"], ww["vals"],
                    ww["emb"], ww["w_out"], ww["b_out"])
        return (ww["gx"], ww["w_x"], ww["wh"], ww["emb"], ww["w_out"],
                ww["b_out"])

    def quant(conv):
        out = (q["emb"][1], q["w_out"][1], q["ls"])
        if fusion == "attention":
            out += (q["att_wh"][1],)
        return tuple(conv(np.array(x)) for x in out)

    att = fusion == "attention"
    jkw = dict(quant=quant(jnp.asarray), compute_dtype=jnp.bfloat16)
    tkw = dict(quant=quant(torch.from_numpy), compute_dtype=torch.bfloat16)
    jargs, targs = args(jnp.asarray), args(torch.from_numpy)
    for greedy in (True, False):
        skw = dict(max_len=8, greedy=greedy)
        jfn = jsd.sharded_attlstm_sample if att else jsd.sharded_lstm_sample
        tfn = tsd.sharded_attlstm_sample if att else tsd.sharded_lstm_sample
        want = jfn(*jargs, jnp.asarray([5, 6], jnp.int32), mesh=jmesh, **skw,
                   **jkw)
        got = tfn(*targs, (5, 6), mesh=tmesh, **skw, **tkw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-3, atol=1e-3)
    jfn = jsd.sharded_attlstm_beam if att else jsd.sharded_lstm_beam
    tfn = tsd.sharded_attlstm_beam if att else tsd.sharded_lstm_beam
    want_seqs, want_sc = jfn(*jargs, mesh=jmesh, beam_size=3, max_len=8,
                             **jkw)
    got_seqs, got_sc = tfn(*targs, mesh=tmesh, beam_size=3, max_len=8, **tkw)
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc),
                               rtol=1e-3, atol=1e-3)


# ----------------------------------------------------------- gate plumbing

def test_shard_decode_ok_and_caps_equal_the_reference():
    for args in ((40, 2, 5), (40, 1, 5), (41, 2, 5), (8, 4, 3)):
        assert tsd.shard_decode_ok(*args) == jsd.shard_decode_ok(*args)
    assert tcore.DECODE_KERNEL_CAPS == jcore.DECODE_KERNEL_CAPS
    for flag in list(jcore.DECODE_KERNEL_CAPS) + ["nonsense_flag"]:
        for axis in ("model", "data"):
            assert (tcore.kernel_supports(flag, axis)
                    == jcore.kernel_supports(flag, axis))


def _gate_cfg(vocab):
    cfg = tpreset("synthetic_smoke")
    cfg.model.vocab_size = vocab
    cfg.model.use_pallas_beam = True
    cfg.model.use_pallas_sampler = True
    return cfg


def test_model_from_config_engages_the_sharded_port(tmesh):
    m = model_from_config(_gate_cfg(40), device="cpu", mesh=tmesh)
    assert m.decode_mesh is tmesh and m.mesh_decline == {}
    assert m.decodes_fused("beam") or m.vshards is None


def test_uneven_vocab_declines_with_reason(tmesh, caplog):
    with caplog.at_level(logging.WARNING, logger="cst_captioning_torch.models"):
        m = model_from_config(_gate_cfg(41), device="cpu", mesh=tmesh)
    assert m.decode_mesh is None
    assert not m.decodes_fused("beam") and not m.decodes_fused("sample")
    assert any("does not tile evenly" in r.getMessage()
               for r in caplog.records)


def test_batch_sharded_mesh_declines(caplog):
    dp = make_mesh({"data": 2, "model": 1}, devices=["cpu"] * 2)
    with caplog.at_level(logging.WARNING, logger="cst_captioning_torch.models"):
        m = model_from_config(_gate_cfg(40), device="cpu", mesh=dp)
    assert m.decode_mesh is None and not m.decodes_fused("beam")
    assert any("batch sharding" in r.getMessage() for r in caplog.records)


def test_sharded_model_decodes_equal_the_single_device_model(tmesh):
    """A model whose vocab is split over the mesh (``shard_vocab``)
    decodes the single-device model's tokens through every route: the
    sharded ladder beam and sampler (greedy and multinomial), and the
    per-step beam with the merge hook."""
    from cst_captioning_torch.decoding.beam import beam_search

    for fusion in ("meanpool", "attention"):
        cfg = _gate_cfg(40)
        cfg.model.feature_fusion = fusion
        one = model_from_config(cfg, device="cpu")
        one.init_weights(torch.Generator().manual_seed(0))
        one.requires_grad_(False)
        two = model_from_config(cfg, device="cpu", mesh=tmesh)
        two.load_state_dict(one.state_dict())
        two.requires_grad_(False)
        two.shard_vocab(tmesh.model_row(0))
        g = torch.Generator().manual_seed(1)
        feats = {"resnet": torch.randn(8, 6, 64, generator=g) * 3}
        masks = {"resnet": torch.ones(8, 6)}
        a = beam_search(one, feats, masks, beam_size=3, max_len=10)
        b = beam_search(two, feats, masks, beam_size=3, max_len=10)
        assert torch.equal(a.tokens, b.tokens)
        for greedy in (True, False):
            kw = dict(max_len=10, greedy=greedy)
            a = one.sample(feats, masks, generator=torch.Generator()
                           .manual_seed(3), **kw)
            b = two.sample(feats, masks, generator=torch.Generator()
                           .manual_seed(3), **kw)
            assert torch.equal(a.tokens, b.tokens)
            torch.testing.assert_close(a.logprobs, b.logprobs, rtol=1e-4,
                                       atol=1e-5)
        assert PAD_ID not in b.tokens[:, 0].tolist()
