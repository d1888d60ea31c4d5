"""Port parity: ``cst_captioning_torch.ops.attlstm`` with the attention
tensors per video (``rep`` caption rows a video, row r reading video
r // rep), against the JAX package's ``ops/pallas_attlstm.py`` on the
repeated tensors, as the reference's ``_repeat_cache`` feeds it.

* forward (plain version): rep in {2, 5} bitwise equal to rep = 1 on the
  repeated tensors, float32 and bfloat16;
* backward (plain version): each video's ``d_proj`` / ``d_vals`` is the
  float32 sum of its rows (each row over reversed time, then the rows in
  row order), rounded once.  Against ``jax.vjp`` of the Pallas kernel in
  interpret mode on ``jnp.repeat``-ed tensors: float32 within 1e-5 x max
  |value|; bfloat16 (on the reference forward's residuals) within one ulp
  (past 1e-3 x max) of the float64-exact sum of the reference kernel's
  own per-row float32 cotangents, where the reference rounds each row and
  adds the rows with one rounded add each (its distance from the exact
  sum is printed beside);
* the autograd Function with rep under a float64 gradcheck;
* refusals of R != B * rep;
* the model's fused attention forward hands the kernel per-video
  tensors, and its logits are bitwise those of the repeated layout;
* the backward's CUDA source uses no float atomics.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import pallas_attlstm as jal
from cst_captioning_torch.models import captioner
from cst_captioning_torch.models.captioner import CaptionModel
from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops import attlstm as tal

FOLD_BF16_ULPS = 1.0
ATOL_REL = 1e-3


def make_problem(B, rep, T, H, A, E, F, seed=0, all_masked=True):
    """Per-video inputs at the model's scales: gx (B * rep, T, 4H), the
    attention tensors (B, F, .); video 0 all masked (unless not
    ``all_masked``), video 1 a masked tail."""
    rng = np.random.RandomState(seed)
    R = B * rep
    f = lambda *s, sc: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    mask = (rng.rand(B, F) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    if all_masked:
        mask[0] = 0.0
    mask[1, F // 2:] = 0.0
    args = [f(R, T, 4 * H, sc=0.5), f(H, 4 * H, sc=0.3), f(E, 4 * H, sc=0.3),
            f(H, A, sc=0.3), f(A, 1, sc=0.3), f(B, F, A, sc=0.5), mask,
            f(B, F, E, sc=0.5)]
    return args, f(R, T, H, sc=1.0)


def to_torch(args, cdt):
    return [torch.from_numpy(a).to(cdt if i not in (0, 6) else torch.float32)
            for i, a in enumerate(args)]


def to_jax(args, cdt):
    return [jnp.asarray(a).astype(cdt if i not in (0, 6) else jnp.float32)
            for i, a in enumerate(args)]


def repeated(args, rep):
    return [np.repeat(a, rep, axis=0) if i in (5, 6, 7) else a
            for i, a in enumerate(args)]


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def bf16_ulps(got, want, atol_rel=ATOL_REL):
    """Largest gap in bf16 ulps of the larger value, past ``atol_rel`` x
    max |want|."""
    g, w = as_np(got), as_np(want)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    gap = np.maximum(np.abs(g - w) - atol_rel * np.abs(w).max(), 0.0)
    return float((gap / ulp).max())


@pytest.mark.parametrize("rep", [2, 5])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_plain_forward_per_video_is_bitwise_the_repeated_layout(rep, cdt):
    args, _ = make_problem(3, rep, 4, 8, 12, 10, 6, seed=rep)
    per_video = tal.attlstm_recurrence_ref(*to_torch(args, cdt), rep,
                                           with_residuals=True)
    gathered = tal.attlstm_recurrence_ref(
        *to_torch(repeated(args, rep), cdt), 1, with_residuals=True)
    for name, x, y in zip(("h_seq", "c_seq", "a_seq"), per_video, gathered):
        assert torch.equal(x, y), name
    h = tal.attlstm_recurrence(*to_torch(args, cdt), rep)
    assert torch.equal(h, per_video[0])


def _jax_vjp(jargs, dh, rep):
    """The reference's cotangents of the per-video tensors: the VJP of
    ``jnp.repeat`` + the Pallas kernel (interpret mode on the CPU)."""
    def f(gx, wh, w_ctx, att_wh, att_v, proj, vals):
        rows = lambda x: jnp.repeat(x, rep, axis=0)  # noqa: E731
        return jal.attlstm_recurrence(gx, wh, w_ctx, att_wh, att_v,
                                      rows(proj), rows(jargs[6]), rows(vals))
    prim = [jargs[i] for i in (0, 1, 2, 3, 4, 5, 7)]
    h, vjp = jax.vjp(f, *prim)
    return vjp(jnp.asarray(dh).astype(h.dtype))


def _port_grads(targs, dh, rep):
    leaves = [x.clone().requires_grad_(i != 6) for i, x in enumerate(targs)]
    h = tal.attlstm_recurrence(*leaves, rep)
    (h.float() * torch.from_numpy(dh)).sum().backward()
    return [leaves[i].grad for i in (0, 1, 2, 3, 4, 5, 7)]


NAMES = ("gx", "wh", "w_ctx", "att_wh", "att_v", "att_proj", "att_vals")


# The Pallas kernels take row counts divisible by 8.
JAX_VIDEOS = {2: 4, 5: 8}


@pytest.mark.parametrize("rep", [2, 5])
def test_plain_backward_per_video_f32_matches_jax_repeat(rep):
    args, dh = make_problem(JAX_VIDEOS[rep], rep, 4, 8, 12, 10, 6,
                            seed=10 + rep)
    want = _jax_vjp(to_jax(args, jnp.float32), dh, rep)
    got = _port_grads(to_torch(args, torch.float32), dh, rep)
    for name, g, w in zip(NAMES, got, want):
        g, w = as_np(g), as_np(w)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name


def _ulps_abs(got, want, atol):
    """Largest gap in bf16 ulps past an absolute ``atol``."""
    g, w = as_np(got), as_np(want)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.maximum(np.abs(g - w) - atol, 0.0) / ulp).max())


@pytest.mark.parametrize("rep", [2, 5])
def test_plain_backward_per_video_bf16_one_rounding(rep):
    """bf16, both sides on the reference forward's residuals: the
    reference's cotangents are ``_vjp_bwd`` (per row, each rounded) then
    the VJP of ``jnp.repeat`` (the rows added with one rounded add each);
    the port folds each video's float32 rows and rounds once.  The port's
    d_proj / d_vals are held within one ulp (past 1e-3 x max) of the
    float64-exact sum of the reference kernel's own float32 rows; their
    distance from the reference's, and the reference's from the exact
    sum, are printed.  The other cotangents at the per-row tier of
    tests/test_torch_attlstm.py (2 ulps past 1e-4; dgx rtol 1e-4)."""
    B, T, H, A, E, F = JAX_VIDEOS[rep], 4, 8, 12, 10, 6
    R = B * rep
    args, dh = make_problem(B, rep, T, H, A, E, F, seed=20 + rep)
    jargs = to_jax(args, jnp.bfloat16)
    jrows = to_jax(repeated(args, rep), jnp.bfloat16)
    jdh = jnp.asarray(dh).astype(jnp.bfloat16)
    h, a, c = jal._fwd_call(*jrows, bt=R, tc=1, with_residuals=True)
    rows = jal._vjp_bwd((*jrows, h, c, a), jdh)
    core = jal._bwd_call(*jrows[:6], jrows[7], h, c, a, jdh, R)
    t = to_torch(args, torch.bfloat16)
    got = tal.attlstm_recurrence_bwd_ref(
        *t[:6], t[7], torch.from_numpy(as_np(h)).to(torch.bfloat16),
        torch.from_numpy(np.array(c)), torch.from_numpy(np.array(a)),
        torch.from_numpy(dh).to(torch.bfloat16), rep)
    for name, i, j, k in (("att_proj", 5, 5, 2), ("att_vals", 7, 6, 3)):
        x = jargs[i]
        want = jax.vjp(lambda y: jnp.repeat(y, rep, axis=0), x)[1](
            rows[i])[0]
        exact = np.asarray(core[k], np.float64).reshape(
            B, rep, *x.shape[1:]).sum(1)
        port = bf16_ulps(got[j], exact)
        print(f"rep={rep} {name}: port {port:.2f} ulps from the exact "
              f"fold, reference {bf16_ulps(want, exact):.2f}, port vs "
              f"reference {bf16_ulps(got[j], want):.2f}")
        assert got[j].dtype == torch.bfloat16
        assert port <= FOLD_BF16_ULPS, name
    for name, i in (("wh", 1), ("w_ctx", 2), ("att_wh", 3), ("att_v", 4)):
        assert _ulps_abs(got[i], rows[i], 1e-4) <= 2.0, name
    np.testing.assert_allclose(as_np(got[0]), as_np(rows[0]), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("rep", [1, 2])
def test_function_gradcheck_f64_with_rep(rep):
    """Finite differences through ``AttLSTMRecurrence`` (plain forward
    and backward in float64): no video fully masked, where the kernel's
    unmasked ``ds`` is the true gradient."""
    args, _ = make_problem(2, rep, 2, 4, 4, 4, 3, seed=30 + rep,
                           all_masked=False)
    t = [torch.from_numpy(a).double() for a in args]
    mask = t[6]
    leaves = [x.requires_grad_() for i, x in enumerate(t) if i != 6]

    def f(gx, wh, w_ctx, att_wh, att_v, proj, vals):
        return tal.AttLSTMRecurrence.apply(gx, wh, w_ctx, att_wh, att_v,
                                           proj, mask, vals, rep)

    assert torch.autograd.gradcheck(f, leaves, eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


@pytest.mark.parametrize("fn", ["ref", "fwd", "function", "bwd", "quant"])
def test_refuses_rows_not_b_times_rep(fn):
    args, dh = make_problem(3, 2, 3, 8, 12, 10, 6)
    t = to_torch(args, torch.float32)
    with pytest.raises(ValueError, match="R must be B \\* rep"):
        if fn == "ref":
            tal.attlstm_recurrence_ref(*t, 3)
        elif fn == "fwd":
            tal.attlstm_recurrence_fwd(*t, 4, with_residuals=True)
        elif fn == "function":
            tal.attlstm_recurrence(*[x.requires_grad_() for x in t], 1)
        elif fn == "bwd":
            h, c, a = tal.attlstm_recurrence_ref(*t, 2, with_residuals=True)
            tal.attlstm_recurrence_bwd(*t[:6], t[7], h, c, a,
                                       torch.from_numpy(dh), 3)
        else:
            codes = torch.zeros((8, 32), dtype=torch.int8)
            tal.attlstm_recurrence_quant_ref(
                t[0], codes, torch.zeros((10, 32), dtype=torch.int8),
                torch.ones(32), torch.zeros((8, 12), dtype=torch.int8),
                torch.ones(12), t[4], t[5], t[6], t[7], torch.float32, rep=5)


def test_backward_core_folds_rows_in_row_order():
    """The plain backward's per-video outputs are its rep = 1 rows folded
    by ``_fold_rows`` (the kernel's rule), bitwise; the wrapper takes the
    plain version on the CPU."""
    rep = 3
    args, dh = make_problem(2, rep, 3, 8, 12, 10, 6, seed=40)
    t = to_torch(args, torch.float32)
    r = to_torch(repeated(args, rep), torch.float32)
    h, c, a = tal.attlstm_recurrence_ref(*t, rep, with_residuals=True)
    d = torch.from_numpy(dh)
    per_video = tal.attlstm_recurrence_bwd_core(*t[:6], t[7], h, c, a, d, rep)
    rows = tal._bwd_core_ref(*r[:6], r[7], h, c, a, d, 1)
    for i in (0, 1):
        assert torch.equal(per_video[i], rows[i])
    for i in (2, 3):
        assert per_video[i].shape[0] == 2
        assert torch.equal(per_video[i], tal._fold_rows(rows[i], rep))


def _model(weight_quant=False):
    m = CaptionModel(vocab_size=40, rnn_size=16, embed_size=16,
                     modalities=("resnet", "c3d"), feature_dims=(24, 32),
                     fusion="attention", att_hidden_size=24,
                     compute_dtype="float32", device="cpu",
                     weight_quant=weight_quant)
    return m.init_weights(torch.Generator().manual_seed(0))


def _inputs(B, repeat, T):
    rng = np.random.RandomState(B)
    feats = {"resnet": torch.from_numpy(rng.randn(B, 5, 24).astype(np.float32)),
             "c3d": torch.from_numpy(rng.randn(B, 5, 32).astype(np.float32))}
    masks = {k: torch.ones(B, 5) for k in feats}
    masks["c3d"][1, 3:] = 0.0
    ids = torch.from_numpy(rng.randint(4, 40, (B * repeat, T))).long()
    ids[:, 0] = 1
    return feats, masks, ids


@pytest.mark.parametrize("weight_quant", [False, True])
def test_fused_attention_forward_passes_per_video_tensors(monkeypatch,
                                                          weight_quant):
    """The teacher-forced attention path hands the recurrence B videos'
    attention tensors with rep = repeat (no ``_repeat_cache``), and its
    logits are bitwise those of the repeated layout at rep = 1."""
    B, repeat, T = 3, 4, 5
    model = _model(weight_quant)
    feats, masks, ids = _inputs(B, repeat, T)
    name = "attlstm_recurrence_quant" if weight_quant else "attlstm_recurrence"
    real = getattr(captioner, name)
    seen = []

    def per_video(*a, **kw):
        rep = kw["rep"] if weight_quant else a[8]
        proj, mask, vals = a[-4:-1] if weight_quant else a[5:8]
        seen.append((a[0].shape[0], proj.shape[0], mask.shape[0],
                     vals.shape[0], rep))
        return real(*a, **kw)

    def gathered(*a, **kw):
        a = list(a)
        if weight_quant:
            rep = kw.pop("rep")
            a[7:10] = [x.repeat_interleave(rep, 0) for x in a[7:10]]
            return real(*a, rep=1)
        a[5:8] = [x.repeat_interleave(a[8], 0) for x in a[5:8]]
        return real(*a[:8], 1)

    with torch.no_grad():
        monkeypatch.setattr(captioner, name, per_video)
        got = model(feats, masks, ids, repeat=repeat)
        monkeypatch.setattr(captioner, name, gathered)
        want = model(feats, masks, ids, repeat=repeat)
    assert seen == [(B * repeat, B, B, B, repeat)]
    assert torch.equal(got, want)


CSRC_OF_RECURRENCE = ("attlstm_recurrence.cu", "attention_tc.cuh",
                      "attention_common.cuh", "tc_common.cuh",
                      "decode_common.cuh")
FLOAT_ATOMIC = re.compile(r"\batomic(Add|Sub|Exch|Max|Min)\w*\s*\(|"
                          r"\b(atom|red)\.(global|shared|add|gpu)")


@pytest.mark.parametrize("name", CSRC_OF_RECURRENCE)
def test_recurrence_sources_use_no_float_atomics(name):
    """The backward's sums are folded in fixed orders (results repeat run
    to run): no atomic adds in the source or the headers it includes."""
    with open(os.path.join(_build.CSRC, name)) as fh:
        src = fh.read()
    assert not FLOAT_ATOMIC.search(src), name
    if name == "attlstm_recurrence.cu":
        incs = set(re.findall(r'#\s*include\s+"([^"]+)"', src))
        assert incs <= set(CSRC_OF_RECURRENCE)
