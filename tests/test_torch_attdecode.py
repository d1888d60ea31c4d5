"""Port parity for the attention-fusion slice: the ``attlstm_beam`` and
``attlstm_sample`` plain versions against the JAX package's twins and
kernels, the attention captioner (encode, per-step context, teacher-
forced logits, one XE step, the weight bridge) against the JAX model,
and served attention captions against the JAX model's fused decoders.

The same numpy inputs go through both packages; the JAX side runs its
Pallas kernels in interpret mode on the CPU (B a multiple of 8 so their
shape gates admit them).  Every decode input holds a video with a
masked frame tail and one with all its frames masked.  Tolerances:

* decode at float32: tokens (and the sampler's mask) exact; beam scores
  within 1e-4 and log-probs within 1e-5 (the products and the
  log-sum-exp summed in another order);
* bfloat16 decode: the reference's relaxed-serving tier;
* float16 decode (beam, greedy, multinomial): the meanpool decoders'
  float16 tier (tests/test_torch_beam.py), caption or row match >= 15/16
  and score rtol <= 1e-4 on the matches, tighter than bf16's;
* teacher-forced logits rtol 1e-4 / atol 1e-5; one XE step: loss rtol
  1e-5, parameters rtol 2e-5 / atol 1e-5 (the meanpool step's bounds,
  tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.analysis.jit_registry import (
    RELAXED_SERVING_MATCH_FLOOR,
    RELAXED_SERVING_SCORE_RTOL,
)
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.data import loader as jloader
from cst_captioning_tpu.decoding.beam import finalize_beams as jfinalize
from cst_captioning_tpu.models.captioner import (
    CaptionModel as JaxModel,
    model_from_config as jax_model_from_config,
)
from cst_captioning_tpu.ops import pallas_beam as jpb
from cst_captioning_tpu.ops import pallas_sampler as jps
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.constants import EOS_ID, PAD_ID
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data import loader as tloader
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import finalize_beams
from cst_captioning_torch.models.captioner import CaptionModel, model_from_config
from cst_captioning_torch.models.weights import (
    load_params,
    params_to_state_dict,
    state_dict_to_params,
)
from cst_captioning_torch.ops import beam as tbeam
from cst_captioning_torch.ops import decode_common as dc
from cst_captioning_torch.ops import sampler as tsam
from cst_captioning_torch.serving.engine import InferenceEngine

SCORE_ATOL = 1e-4
LP_ATOL = 1e-5


def make_args(B=8, H=16, E=16, A=24, F=6, V=50, seed=0, gx=0.1):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=0.3: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    mask = (rng.rand(B, F) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1] = 0.0
    mask[2, F // 2:] = 0.0
    return dict(
        gx_static=f(B, 4 * H, sc=gx), w_x=f(E, 4 * H), wh=f(H, 4 * H),
        w_ctx=f(E, 4 * H), att_wh=f(H, A), att_v=f(A, 1),
        att_proj=f(B, F, A, sc=0.5), att_mask=mask,
        att_vals=f(B, F, E, sc=0.5), emb=f(V, E), w_out=f(H, V),
        b_out=f(V, sc=0.1),
    )


def run_jax(args, *extra, fn, **kw):
    out = fn(*(jnp.asarray(v) for v in args.values()), *extra, **kw)
    return tuple(np.asarray(x) for x in out)


def run_port(args, *extra, fn, **kw):
    out = fn(*(torch.from_numpy(v) for v in args.values()), *extra, **kw)
    return tuple(x.numpy() for x in out)


def assert_beam_match(j, p):
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=SCORE_ATOL)


def assert_sample_match(j, p):
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=LP_ATOL)
    np.testing.assert_array_equal(p[2], j[2])


# --------------------------------------------------------------- beam

@pytest.mark.parametrize("beam_size,max_len,seed", [
    (1, 6, 0), (3, 8, 1), (5, 10, 2), (4, 5, 3),
])
def test_beam_ref_matches_jax_twin(beam_size, max_len, seed):
    args = make_args(seed=seed)
    kw = dict(beam_size=beam_size, max_len=max_len)
    j = run_jax(args, fn=jpb.attlstm_beam_scan, **kw)
    p = run_port(args, fn=tbeam.attlstm_beam_ref, **kw)
    assert_beam_match(j, p)
    assert p[0].shape == (8, beam_size, max_len) and p[0].dtype == np.int32


def test_beam_ref_matches_pallas_kernel_interpret():
    args = make_args(H=8, E=8, A=8, F=5, V=20, seed=4)
    kw = dict(beam_size=3, max_len=5)
    assert_beam_match(run_jax(args, fn=jpb.attlstm_beam, **kw),
                      run_port(args, fn=tbeam.attlstm_beam_ref, **kw))


def test_beam_multi_tile_vocab_and_eos_freeze():
    """V=1100 spans several reference tiles plus a padded tail (the
    LSE chunk width comes from the picker with the real F and A); EOS
    rigged to win freezes beams with PAD at zero cost."""
    args = make_args(V=1100, H=32, E=32, A=32, seed=5)
    args["b_out"][EOS_ID] = 1.5
    kw = dict(beam_size=4, max_len=6)
    j = run_jax(args, fn=jpb.attlstm_beam_scan, **kw)
    p = run_port(args, fn=tbeam.attlstm_beam_ref, **kw)
    assert_beam_match(j, p)
    assert p[0].max() < 1100
    ended = (p[0] == EOS_ID).any(-1)
    assert ended.any()


def test_beam_masked_frames_cannot_leak():
    """Values at masked frames do not reach the decode, and a video
    with every frame masked decodes with uniform weights (finite)."""
    args = make_args(seed=6)
    kw = dict(beam_size=3, max_len=6)
    ref = run_port(args, fn=tbeam.attlstm_beam_ref, **kw)
    live = args["att_mask"].sum(-1) > 0
    vals = args["att_vals"]
    vals[live] = np.where(args["att_mask"][live][..., None] > 0,
                          vals[live], 1e3)
    got = run_port(args, fn=tbeam.attlstm_beam_ref, **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert np.isfinite(ref[1]).all()


def test_beam_pick_uses_attention_widths():
    """The plain version's LSE chunk width is the reference picker's at
    the real F and A (at MSR-VTT widths in f32 it narrows to 128)."""
    for B, K, F, A, E, H, L, isz in ((64, 5, 56, 512, 512, 512, 30, 4),
                                     (64, 5, 56, 512, 512, 512, 30, 2),
                                     (8, 3, 6, 24, 16, 16, 8, 4)):
        assert dc.beam_pick_tiles(B, K, F, A, E, H, L, isz) == \
            jpb._pick_tiles(B, K, F, A, E, H, L, isz)
    assert dc.beam_pick_tiles(64, 5, 56, 512, 512, 512, 30, 4)[1] == 128


# ------------------------------------------------------------ sampler

@pytest.mark.parametrize("greedy,temperature,seed", [
    (True, 1.0, 0), (False, 1.0, 1), (False, 0.7, 2), (False, 1.5, 3),
])
def test_sample_ref_matches_jax_twin(greedy, temperature, seed):
    args = make_args(seed=seed)
    words = [int(x) for x in np.random.RandomState(seed).randint(
        -2**31, 2**31 - 1, size=2)]
    kw = dict(max_len=9, greedy=greedy, temperature=temperature)
    j = run_jax(args, jnp.asarray(words, jnp.int32),
                fn=jps.attlstm_sample_scan, **kw)
    p = run_port(args, words, fn=tsam.attlstm_sample_ref, **kw)
    assert_sample_match(j, p)
    assert p[0].dtype == np.int32 and p[0].shape == (8, 9)


def test_sample_ref_matches_pallas_kernel_interpret():
    args = make_args(H=8, E=8, A=8, F=5, V=20, seed=9)
    for greedy in (True, False):
        kw = dict(max_len=5, greedy=greedy)
        j = run_jax(args, jnp.asarray([11, 22], jnp.int32),
                    fn=jps.attlstm_sample, **kw)
        p = run_port(args, [11, 22], fn=tsam.attlstm_sample_ref, **kw)
        assert_sample_match(j, p)


def test_sample_multinomial_multi_tile_and_batch_tiles():
    """V=1100 (padded V_pad in the counter) and B=48 (several stream
    batch tiles at the attention geometry)."""
    args = make_args(B=48, V=1100, seed=5)
    kw = dict(max_len=6, greedy=False)
    j = run_jax(args, jnp.asarray([123, -456], jnp.int32),
                fn=jps.attlstm_sample_scan, **kw)
    p = run_port(args, [123, -456], fn=tsam.attlstm_sample_ref, **kw)
    assert_sample_match(j, p)


@pytest.mark.parametrize("B,F,A,E,H,itemsize,want", [
    (64, 56, 512, 512, 512, 2, (32, 512)),   # MSR-VTT attention, bf16
    (64, 56, 512, 512, 512, 4, (8, 128)),    # the same in f32
    (64, 0, 0, 512, 512, 2, (64, 512)),      # meanpool bf16
    (48, 6, 24, 16, 16, 4, None),
])
def test_stream_geometry_with_attention_operands(B, F, A, E, H, itemsize,
                                                 want):
    """The multinomial stream's (bt, V_pad) follows the reference
    picker with the attention operands counted."""
    got = dc.sampler_pick_tiles(B, F, A, E, H, itemsize)
    assert got == jps._pick_tiles(B, F, A, E, H, itemsize)
    if want is not None:
        assert got == want
    cdt = torch.bfloat16 if itemsize == 2 else torch.float32
    bt, V_pad = tsam.stream_geometry(B, E, H, cdt, 10_496, F, A)
    assert bt == got[0] and V_pad % got[1] == 0 and V_pad >= 10_496


def test_sample_finished_rows_and_all_masked_video():
    args = make_args(seed=7)
    args["b_out"][EOS_ID] = 6.0
    kw = dict(max_len=6, greedy=True)
    j = run_jax(args, jnp.asarray([0, 0], jnp.int32),
                fn=jps.attlstm_sample_scan, **kw)
    p = run_port(args, (0, 0), fn=tsam.attlstm_sample_ref, **kw)
    assert_sample_match(j, p)
    toks, lps, mask = p
    assert np.isfinite(lps).all()
    fin = (toks == EOS_ID).cumsum(1) > 0
    after = np.concatenate([np.zeros((8, 1), bool), fin[:, :-1]], 1)
    assert np.all(toks[after] == PAD_ID) and np.all(mask[after] == 0.0)


def test_wrappers_take_plain_versions_on_cpu():
    args = make_args(seed=12)
    before = (tbeam.attlstm_beam.launches, tsam.attlstm_sample.launches)
    a = run_port(args, fn=tbeam.attlstm_beam, beam_size=3, max_len=5)
    b = run_port(args, fn=tbeam.attlstm_beam_ref, beam_size=3, max_len=5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = run_port(args, [1, 2], fn=tsam.attlstm_sample, max_len=5, greedy=False)
    b = run_port(args, [1, 2], fn=tsam.attlstm_sample_ref, max_len=5,
                 greedy=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (tbeam.attlstm_beam.launches,
            tsam.attlstm_sample.launches) == before


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_bf16_relaxed_serving_tier_vs_jax(mode):
    """bfloat16 operands: best-caption (or row) match >= the reference's
    relaxed-serving floor, score rtol <= its bound on the matches."""
    args = make_args(B=16, H=32, E=32, A=32, F=8, V=600, seed=20)
    f32 = ("gx_static", "b_out", "att_mask")
    jx = [jnp.asarray(v, jnp.float32 if k in f32 else jnp.bfloat16)
          for k, v in args.items()]
    tx = [torch.from_numpy(v).to(torch.float32 if k in f32 else torch.bfloat16)
          for k, v in args.items()]
    if mode == "beam":
        kw = dict(beam_size=3, max_len=10)
        j = jfinalize(*jpb.attlstm_beam_scan(*jx, **kw))
        p = finalize_beams(*tbeam.attlstm_beam_ref(*tx, **kw))
        jt, pt = np.asarray(j.tokens), p.tokens.numpy()
        js, ps = np.asarray(j.score), p.score.numpy()
    else:
        kw = dict(max_len=10, greedy=True)
        j = jps.attlstm_sample_scan(*jx, jnp.asarray([5, 6], jnp.int32), **kw)
        p = tsam.attlstm_sample_ref(*tx, (5, 6), **kw)
        jt, pt = np.asarray(j[0]), p[0].numpy()
        js, ps = np.asarray(j[1]).sum(-1), p[1].numpy().sum(-1)
    same = (jt == pt).all(-1)
    assert same.mean() >= RELAXED_SERVING_MATCH_FLOOR
    assert (np.abs(js - ps)[same] / np.abs(js[same])).max() <= \
        RELAXED_SERVING_SCORE_RTOL


F16_MATCH_FLOOR = 15 / 16
F16_SCORE_RTOL = 1e-4


@pytest.mark.parametrize("mode", ["beam", "greedy", "multinomial"])
@pytest.mark.parametrize("seed", [20, 21])
def test_f16_tier_vs_jax(mode, seed):
    """float16 operands against the JAX twins at float16 (the kernels'
    dtype code 2): the masked frames' -1e30 stays in the float32 scores
    and the f16 tanh's result is rounded as XLA rounds it
    (``ops/attlstm.py::tanh_of``)."""
    args = make_args(B=16, H=32, E=32, A=32, F=8, V=600, seed=seed)
    f32 = ("gx_static", "b_out", "att_mask")
    jx = [jnp.asarray(v, jnp.float32 if k in f32 else jnp.float16)
          for k, v in args.items()]
    tx = [torch.from_numpy(v).to(torch.float32 if k in f32 else torch.float16)
          for k, v in args.items()]
    if mode == "beam":
        kw = dict(beam_size=3, max_len=10)
        j = jfinalize(*jpb.attlstm_beam_scan(*jx, **kw))
        p = finalize_beams(*tbeam.attlstm_beam_ref(*tx, **kw))
        jt, pt = np.asarray(j.tokens), p.tokens.numpy()
        js, ps = np.asarray(j.score), p.score.numpy()
    else:
        kw = dict(max_len=10, greedy=mode == "greedy")
        j = jps.attlstm_sample_scan(*jx, jnp.asarray([5, 6], jnp.int32), **kw)
        p = tsam.attlstm_sample_ref(*tx, (5, 6), **kw)
        jt, pt = np.asarray(j[0]), p[0].numpy()
        js, ps = np.asarray(j[1]).sum(-1), p[1].numpy().sum(-1)
        np.testing.assert_array_equal(p[2].numpy()[(jt == pt).all(-1)],
                                      np.asarray(j[2])[(jt == pt).all(-1)])
    assert np.isfinite(ps).all()
    same = (jt == pt).all(-1)
    assert same.mean() >= F16_MATCH_FLOOR
    assert (np.abs(js - ps)[same] / np.abs(js[same])).max() <= F16_SCORE_RTOL


# ------------------------------------------------------------- model

E, H, A, V, D1, D2, FR = 16, 16, 24, 40, 24, 32, 5


def _jax_att_model(**kw):
    return JaxModel(vocab_size=V, rnn_size=H, embed_size=E,
                    modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                    fusion="attention", att_hidden_size=A,
                    compute_dtype="float32", drop_prob=0.0, **kw)


def _port_att_model():
    return CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                        modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                        fusion="attention", att_hidden_size=A,
                        compute_dtype="float32", device="cpu")


def _feats(B, seed):
    rng = np.random.RandomState(seed)
    feats = {"resnet": rng.randn(B, FR, D1).astype(np.float32),
             "c3d": rng.randn(B, FR, D2).astype(np.float32)}
    masks = {m: (rng.rand(B, FR) > 0.3).astype(np.float32) for m in feats}
    for m in masks:
        masks[m][:, 0] = 1.0
    masks["resnet"][1, 2:] = 0.0
    return feats, masks


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def att_params():
    feats, masks = _feats(8, 0)
    p = _jax_att_model().init(jax.random.PRNGKey(0), _j(feats), _j(masks),
                              jnp.zeros((8, 2), jnp.int32))
    return jax.tree.map(np.asarray, p)


def test_bridge_round_trips_attention_leaves(att_params):
    names = set(att_params["params"])
    assert {"att_wf", "att_wh", "att_b", "att_v"} <= names
    pm = load_params(_port_att_model(), att_params)
    assert set(pm.state_dict()) == names
    assert tuple(pm.att_v.shape) == (A, 1)
    back = state_dict_to_params(pm.state_dict())
    for k, v in att_params["params"].items():
        np.testing.assert_array_equal(back["params"][k], v)
    sd = params_to_state_dict(back)
    for k in ("att_wf", "att_wh", "att_b", "att_v"):
        np.testing.assert_array_equal(sd[k].numpy(), att_params["params"][k])


def test_init_distributions():
    m = _port_att_model().init_weights(torch.Generator().manual_seed(0))
    assert torch.all(m.att_b == 0.0)
    for name, (fi, fo) in (("att_wf", (E, A)), ("att_wh", (H, A)),
                           ("att_v", (A, 1))):
        w = getattr(m, name)
        assert tuple(w.shape) == (fi, fo)
        assert float(w.detach().abs().max()) <= (6.0 / (fi + fo)) ** 0.5


def test_encode_and_step_match_jax(att_params):
    """The attention cache (frames concatenated in modality order, the
    masks alike, att_proj) and one unfused step through the dense
    context: rtol / atol 1e-5."""
    feats, masks = _feats(3, 1)
    jm = _jax_att_model()
    state, cache = jm.apply(att_params, _j(feats), _j(masks),
                            method="init_decode")
    tokens = jnp.asarray([1, 7, 12], jnp.int32)
    _, jlogits = jm.apply(att_params, state, cache, tokens,
                          method="decode_logits")
    pm = load_params(_port_att_model(), att_params)
    pstate, pcache = pm.init_decode(_t(feats), _t(masks))
    for k in ("att_vals", "att_proj", "att_mask"):
        np.testing.assert_allclose(getattr(pcache, k).numpy(),
                                   np.asarray(getattr(cache, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert pcache.att_vals.shape == (3, 2 * FR, E)
    _, h_top = pm._step(pstate, pcache, torch.tensor([1, 7, 12]))
    plogits = pm.mask_decode_logits(pm._logits(h_top))
    np.testing.assert_allclose(plogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,repeat,T", [(4, 2, 6), (8, 1, 5)])
def test_teacher_forced_logits_match_jax(att_params, B, repeat, T):
    """The fused attention forward with ``repeat`` caption rows per
    video, against the JAX model with ``use_pallas_attention`` (its
    kernel in interpret mode)."""
    feats, masks = _feats(B, B)
    rng = np.random.RandomState(T)
    ids = rng.randint(4, V, (B * repeat, T)).astype(np.int32)
    ids[:, 0] = 1
    jm = _jax_att_model(use_pallas_attention=True)
    want = jm.apply(att_params, _j(feats), _j(masks), jnp.asarray(ids),
                    repeat=repeat)
    pm = load_params(_port_att_model(), att_params)
    got = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
             repeat=repeat)
    assert got.shape == (B * repeat, T, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def _att_cfgs():
    jc = jcfg.get_preset("synthetic_smoke")
    tc = tcfg.get_preset("synthetic_smoke")
    for c in (jc, tc):
        c.model.feature_fusion = "attention"
    jc.model.use_pallas_attention = True
    return jc, tc


def test_xe_step_matches_jax_step():
    """One attention XE step from bridged params on ``synthetic_smoke``
    (f32, drop_prob 0, 8 videos x 3 captions): loss rtol 1e-5; params
    after the Adam update rtol 2e-5 / atol 1e-5."""
    jc, tc = _att_cfgs()
    jds, vocab = jbuild.build_dataset(jc, "train")
    tds, _ = tbuild.build_dataset(tc, "train")
    jc.model.vocab_size = tc.model.vocab_size = len(vocab)
    kw = dict(batch_size=jc.data.batch_size, seq_per_img=jc.data.seq_per_img,
              max_frames=jc.data.max_frames, seed=5)
    jb = next(iter(jloader.BatchIterator(jds, **kw).epoch(0)))
    tb = next(iter(tloader.BatchIterator(tds, **kw).epoch(0)))
    jb.feat_masks["resnet"][1, 2:] = 0.0
    tb.feat_masks["resnet"][1, 2:] = 0.0

    jm = jax_model_from_config(jc)
    assert jm.fusion == "attention" and jm.use_pallas_attention
    tx = jsteps.make_optimizer(jc.train, 4)
    state = jsteps.create_train_state(jax.random.PRNGKey(0), jm, tx,
                                      jb._asdict())
    init_params = jax.tree.map(np.array, state.params)
    step = jsteps.make_xe_train_step(jm)
    new_state, metrics = step(state, jb.feats, jb.feat_masks, jb.captions,
                              jb.weights, None, jb.video_idx,
                              jax.random.PRNGKey(1), 0.0)

    tm = model_from_config(tc, device="cpu")
    load_params(tm, init_params)
    from cst_captioning_torch.training import steps as tsteps

    opt = tsteps.make_optimizer(tc.train, 4, dict(tm.named_parameters()))
    tstep = tsteps.make_xe_train_step(tm, opt)
    tb = tloader.to_device(tb, torch.device("cpu"))
    out = tstep(tb.feats, tb.feat_masks, tb.captions, tb.weights, None,
                tb.video_idx, None, 0.0)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    assert {"att_wf", "att_wh", "att_b", "att_v"} <= set(
        new_state.params["params"])
    for k, v in new_state.params["params"].items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), np.asarray(v),
                                   rtol=2e-5, atol=1e-5, err_msg=k)


# ----------------------------------------------------------- serving

@pytest.fixture(scope="module")
def served():
    """A JAX attention model with its decode kernels on (interpret mode)
    and the port's engine on the same weights."""
    jc, pc = _att_cfgs()
    vocab = Vocabulary([f"w{i}" for i in range(60)])
    for c in (jc, pc):
        c.model.vocab_size = len(vocab)
        c.serving.continuous = False
        c.serving.warmup = False
    jm = jax_model_from_config(jc).clone(use_pallas_beam=True,
                                         use_pallas_sampler=True)
    d = jc.data
    zf = {m: jnp.zeros((8, d.max_frames, d.feature_dims[m]), jnp.float32)
          for m in d.feature_modalities}
    zm = {m: jnp.ones((8, d.max_frames), jnp.float32) for m in zf}
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(3), zf, zm, jnp.zeros((8, 2), jnp.int32)))
    return jm, params, pc, vocab


def _payloads(n, dim, seed):
    rng = np.random.RandomState(seed)
    return [{"features": {"resnet": (rng.randn(int(rng.choice([1, 3, 6, 9])),
                                               dim) * 2.0).astype(np.float32)}}
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_served_captions_token_exact_vs_jax_fused(served, mode):
    """The port's ladder engine (attention, f32, CPU) against the JAX
    model's ``fused_beam`` / fused sampler on the same padded batch."""
    jm, params, pc, vocab = served
    pc.serving.decode_mode = mode
    eng = InferenceEngine(pc, params=params, vocab=vocab, device="cpu")
    reqs = [eng.prepare(p) for p in _payloads(5, 64, seed=len(mode))]
    got = [r.tokens for r in eng.decode_prepared(reqs, store=False)]
    feats, masks = eng._assemble(reqs, eng.bucket(len(reqs)))
    jf = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    jmk = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    L = pc.eval.max_decode_len
    if mode == "beam":
        seqs, scores = jm.apply(params, jf, jmk, method="fused_beam",
                                beam_size=pc.eval.beam_size, max_len=L)
        want = np.asarray(jfinalize(seqs, scores).tokens)
    else:
        want = np.asarray(jm.apply(params, jf, jmk, method="sample",
                                   max_len=L, greedy=True).tokens)
    assert got == want[:len(reqs)].tolist()
    assert eng.model.fusion == "attention"
