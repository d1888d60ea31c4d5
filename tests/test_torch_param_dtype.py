"""``model.param_dtype`` in the port: bfloat16 / float16 parameter leaves
through the model, the optimizer, checkpoints, the weight bridge, int8w,
the mesh and serving, against the JAX package on the CPU (its Pallas
sites in interpret mode, ``use_pallas_lstm`` / ``use_pallas_attention``
on, as its own tests run them).

Small widths: ``synthetic_smoke`` (vocab 40, H = E = A = 32), both
fusions, inputs from numpy seeds.

The exact-order update witness.  A check of one update step against the
reference splits in two, so that Adam's first step ``lr * g / (|g| +
eps)``, which amplifies any difference of a gradient near ``eps``, never
amplifies the two packages' summation orders:

* the gradients against the reference's (captured by a transformation
  that hands the reference's own step's gradients back as its state,
  :func:`capture`), at the gradient tier, where nothing amplifies them;
* the port's update applied to the port's own gradients against the
  reference's optax chain (jitted, as its train step runs it) fed those
  same gradients (:func:`update_witness`): the update's order alone,
  held at the tight tier.

Tiers:

* leaf dtypes: equal to the JAX ``model.init`` tree's, leaf by leaf
  (the int8w ``<name>_scale`` leaves float32; ``float64`` builds float32
  with a warning, as JAX without x64 does);
* ``model.compute_dtype = "float64"`` builds a float32-compute model
  and warns once, as JAX without x64 computes; attention fusion at
  ``compute_dtype = "float16"`` meets no dtype gate: for a CUDA device
  it builds as bfloat16 attention does (on a host without a card both
  stop at the device), and on the CPU it builds;
* the optimizer on bf16 leaves against the jitted optax chain, 5 updates,
  every case of ``OPTIMIZER_CASES``: the norm bitwise, moments bf16,
  leaves bitwise for adam / adamw / sgd, within one bf16 ulp for
  rmsprop (XLA's CPU rsqrt is not correctly rounded: 6 of 10,000 bf16
  values differ from the rounded root);
* one XE step and one PG update on bf16 leaves: loss rtol 1e-5; each
  gradient leaf within ``GRAD_TIER[compute dtype]`` of its largest
  reference element: one bf16 ulp of it at float32 compute; sixteen at
  bfloat16 compute, where the cotangents round through the bf16
  activations (as the f32-leaf model's do) and the attention
  backward's bf16 ``d_proj``, so a bias gradient summed over frames
  with cancellation reads 3.4e-2 of its largest element (PG,
  attention); the update witness bitwise;
* one XE step and one PG update at float16 compute, both fusions, on
  float32 and on float16 leaves: loss rtol 1e-5; each gradient leaf
  within ``GRAD_TIER["float16"]`` = 2^-5 of its largest reference
  element, half the bfloat16 tier: the worst reading is 1.55e-2 (PG,
  attention, float16 leaves, ``att_b``; meanpool 7.9e-4), so the tier
  holds it with a margin of 2; the update witness within two float16
  ulps on float16 leaves (``_update_ulps``) and within 4 float32 ulps
  (of the update and of the leaf) on float32 leaves, as the CST witness
  of ``test_torch_category.py`` holds float32 leaves.  Adam on float16
  leaves follows optax into
  non-finite leaves: optax rounds ``eps = 1e-8`` into the leaf dtype,
  0 in float16, so an element whose gradient is 0 (a word absent from
  the batch) updates by 0 / 0 and one whose ``g^2 (1 - b2)`` underflows
  by ``m / 0``; the witness holds the port to the same NaN and inf
  elements (a NaN equals a NaN there);
* the bridge, save / restore / resume, the importer, the trainer's
  resume, an artifact boot, reshard: bitwise; the CST split, padded and
  slot steps keep bf16 leaves and moments;
* a float32 checkpoint warm-started into a bf16 model: bitwise orbax's
  restore into a bf16 template (round to nearest even);
* ``quantize_params`` from bf16 leaves: codes and scales equal;
* the (2, 2) mesh step: its folded gradients within two bf16 ulps of
  the largest one-device element (``MESH_FOLD_TIER``: each shard's
  gradient rounds, then their bf16 sum, where one device rounds
  once), its update bitwise the one-device
  ``Optimizer`` fed the same gradients; two gloo processes bitwise the
  (2, 1) mesh step;
* served tokens: the port's engines on bf16 leaves against the JAX
  engine built with the same ``param_dtype``: token-exact at f32
  serving, the relaxed-serving floor at bf16 and int8w.
"""

import os
import socket
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.analysis.jit_registry import (
    RELAXED_SERVING_MATCH_FLOOR,
)
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.data import loader as jloader
from cst_captioning_tpu.decoding import speculative as jspec
from cst_captioning_tpu.models.captioner import (
    model_from_config as jax_model_from_config,
)
from cst_captioning_tpu.ops import quant as jq
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_tpu.training import checkpoint as jckpt
from cst_captioning_tpu.training import cst as jcst
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data import loader as tloader
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding import speculative as tspec
from cst_captioning_torch.models import captioner as tcap
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.models.weights import (
    load_params,
    state_dict_to_params,
)
from cst_captioning_torch.ops import quant as tq
from cst_captioning_torch.parallel import make_mesh
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.tools import import_jax_checkpoint as importer
from cst_captioning_torch.training import checkpoint as tckpt
from cst_captioning_torch.training import cst as tcst
from cst_captioning_torch.training import sharded
from cst_captioning_torch.training import steps as tsteps
from cst_captioning_torch.training.trainer import Trainer

from test_torch_int8w_serving import _cfg as _int8w_cfg
from test_torch_int8w_serving import _ladder, _match, _payloads, _slots
from test_torch_train import OPTIMIZER_CASES, _train_cfgs

REPO = __file__.rsplit("/tests/", 1)[0]
FUSIONS = ("meanpool", "attention")
GRAD_TIER = {"float32": 2.0 ** -8, "bfloat16": 2.0 ** -4,
             "float16": 2.0 ** -5}
MESH_FOLD_TIER = 2.0 ** -7
JAX_DT = {"bfloat16": jnp.bfloat16, "float16": jnp.float16,
          "float32": jnp.float32}
TORCH_DT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}


# ------------------------------------------------------------ helpers

def cfgs(fusion="meanpool", pdt="bfloat16", cdt="bfloat16"):
    """(JAX, port) ``synthetic_smoke`` configs with ``fusion``, leaves in
    ``pdt`` and compute in ``cdt``; JAX on its Pallas recurrences."""
    out = []
    for mod in (jcfg, tcfg):
        c = mod.get_preset("synthetic_smoke")
        c.model.feature_fusion = fusion
        c.model.param_dtype = pdt
        c.model.compute_dtype = cdt
        out.append(c)
    out[0].model.use_pallas_lstm = True
    out[0].model.use_pallas_attention = True
    return out


def first_batches(jc, tc):
    jds, vocab = jbuild.build_dataset(jc, "train")
    tds, _ = tbuild.build_dataset(tc, "train")
    jc.model.vocab_size = tc.model.vocab_size = len(vocab)
    kw = dict(batch_size=jc.data.batch_size, seq_per_img=jc.data.seq_per_img,
              max_frames=jc.data.max_frames, seed=5)
    jb = next(iter(jloader.BatchIterator(jds, **kw).epoch(0)))
    tb = next(iter(tloader.BatchIterator(tds, **kw).epoch(0)))
    return jds, tds, jb, tloader.to_device(tb, torch.device("cpu"))


def to_torch(x) -> torch.Tensor:
    """A JAX / numpy leaf as a torch tensor of its own dtype (exactly)."""
    a = np.asarray(x)
    dt = str(a.dtype)
    t = torch.from_numpy(np.array(a.astype(np.float32) if dt in TORCH_DT
                                  else a))
    return t.to(TORCH_DT[dt]) if dt in TORCH_DT else t


def to_jax(t: torch.Tensor):
    """A torch leaf as a JAX array of its own dtype (exactly)."""
    name = str(t.dtype).replace("torch.", "")
    if name in JAX_DT:
        return jnp.asarray(t.detach().float().numpy(), JAX_DT[name])
    return jnp.asarray(t.detach().numpy())


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in representable values between two 16-bit float
    tensors of one dtype (sign-aware)."""
    assert a.dtype == b.dtype and a.element_size() == 2

    def key(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)

    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def capture() -> optax.GradientTransformation:
    """A transformation whose update is zero and whose state is the
    gradients it was given: the reference's own step, run with it,
    returns its gradients in ``opt_state`` and its parameters as they
    were (``p + 0``)."""

    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def hold_grads(port: dict, ref: dict, tol: float, what: str) -> None:
    """The gradient tier: every leaf's dtype the reference's, and each
    element within ``tol`` of the leaf's largest reference magnitude."""
    assert set(port) == set(ref), what
    for k, g in port.items():
        r = to_torch(ref[k])
        assert g.dtype == r.dtype, (what, k, g.dtype, r.dtype)
        scale = float(r.float().abs().max())
        err = float((g.float() - r.float()).abs().max())
        assert err <= tol * scale, (what, k, err, scale)


def update_witness(tx, params: dict, grads: dict, port_after: dict,
                   ulp: int = 0) -> None:
    """The reference's optax chain ``tx`` (jitted, from its fresh state)
    fed the port's own ``grads`` from ``params`` (dicts of torch
    tensors) against the port's leaves after its update, ``port_after``:
    bitwise, or within ``ulp`` units in the last place of a 16-bit
    leaf; a float32 leaf within ``ulp`` units in the last place of the
    update ``p_after - p`` plus ``ulp`` of the leaf (the chain's float32
    norm sums in XLA's order, so its last bit may move every clipped
    update by an ulp, and ``p + u`` may cancel to a small leaf)."""
    jp = {"params": {k: to_jax(v) for k, v in params.items()}}
    jg = {"params": {k: to_jax(v) for k, v in grads.items()}}
    upd, _ = jax.jit(tx.update)(jg, tx.init(jp), jp)
    want = jax.jit(optax.apply_updates)(jp, upd)["params"]
    for k, v in port_after.items():
        w = to_torch(want[k])
        assert v.dtype == w.dtype, (k, v.dtype, w.dtype)
        if ulp == 0:
            same = (v == w) | (v.isnan() & w.isnan())
            assert bool(same.all()), (k, float((v.float() - w.float())
                                               .abs().max()))
        elif v.element_size() == 2:
            assert ulps(v, w) <= ulp, k
        else:
            v64, w64 = v.double().numpy(), w.double().numpy()
            step = np.abs(w64 - params[k].double().numpy())
            bound = ulp * (np.spacing(step.astype(np.float32))
                           + np.spacing(np.abs(w.numpy())))
            assert (np.abs(v64 - w64) <= bound).all(), k


class Recording(tsteps.Optimizer):
    """The port's optimizer, keeping the gradients of its last step."""

    def step(self, grads):
        self.seen = {k: g.detach().clone() for k, g in grads.items()}
        return super().step(grads)


def jax_init(jm, jb, seed=0):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jm.init(jax.random.PRNGKey(seed),
                       {m: jnp.asarray(v[:1]) for m, v in jb.feats.items()},
                       {m: jnp.asarray(v[:1])
                        for m, v in jb.feat_masks.items()},
                       jnp.zeros((1, 2), jnp.int32))


def dtype_names(tree) -> dict:
    return {k: str(np.asarray(v).dtype) for k, v in tree.items()}


def port_dtype_names(sd) -> dict:
    return {k: str(v.dtype).replace("torch.", "") for k, v in sd.items()}


# ------------------------------------------------------------- leaves

@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("pdt", ["bfloat16", "float16", "float64"])
def test_leaf_dtypes_match_jax_init(pdt, fusion, quant):
    """Every leaf in ``param_dtype`` as the JAX ``model.init`` tree holds
    it (``float64``: float32 leaves and a warning naming the
    truncation); under int8w the codes int8 and the scales float32, as
    the JAX ``quantize_params`` of that tree."""
    jc, tc = cfgs(fusion, pdt)
    _, _, jb, _ = first_batches(jc, tc)
    sdt = "int8w" if quant else None
    want = dict(jax_init(jax_model_from_config(jc), jb)["params"])
    if quant:
        want = jq.quantize_params(want)
    if pdt == "float64":
        with pytest.warns(UserWarning, match="float64.*float32"):
            tm = model_from_config(tc, serving_dtype=sdt, device="cpu")
    else:
        tm = model_from_config(tc, serving_dtype=sdt, device="cpu")
    got = port_dtype_names(tm.state_dict())
    assert got == dtype_names(want)
    leaf = "float32" if pdt == "float64" else pdt
    assert {v for k, v in got.items() if not k.endswith("_scale")} == (
        {leaf, "int8"} if quant else {leaf})
    if quant:
        assert {v for k, v in got.items() if k.endswith("_scale")} == {
            "float32"}


def test_unknown_param_dtype_is_refused():
    _, tc = cfgs(pdt="int32")
    tc.model.vocab_size = 40
    with pytest.raises(ValueError, match="model.param_dtype"):
        model_from_config(tc, device="cpu")


@pytest.mark.parametrize("pdt", ["bfloat16", "float16"])
def test_init_weights_rounds_float32_draws_once(pdt):
    _, tc = cfgs(pdt=pdt)
    tc.model.vocab_size = 40
    tm = model_from_config(tc, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(3))
    tc.model.param_dtype = "float32"
    f32 = model_from_config(tc, device="cpu")
    f32.init_weights(torch.Generator().manual_seed(3))
    for k, v in tm.state_dict().items():
        assert v.dtype == TORCH_DT[pdt]
        assert torch.equal(v, f32.state_dict()[k].to(TORCH_DT[pdt])), k


# ---------------------------------------------------------- optimizer

@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_optax_chain_on_bf16_leaves(case):
    """5 updates, the LR decaying every 2 steps, against the jitted
    chain: norm bitwise, moments bf16, leaves bitwise (rmsprop within
    one ulp)."""
    jc, tc = _train_cfgs(lr_decay=0.5, lr_decay_every=1,
                         **OPTIMIZER_CASES[case])
    rng = np.random.RandomState(7)
    init = {"b": rng.randn(5, 7), "a": rng.randn(30, 40)}
    tx = jsteps.make_optimizer(jc, 2)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: to_torch(v) for k, v in jp.items()}
    opt = tsteps.make_optimizer(tc, 2, tp)
    upd_fn, apply_fn = jax.jit(tx.update), jax.jit(optax.apply_updates)
    for step in range(5):
        jg = {k: jnp.asarray(rng.randn(*v.shape) * 3, jnp.bfloat16)
              for k, v in init.items()}
        upd, state = upd_fn(jg, state, jp)
        jp = apply_fn(jp, upd)
        gnorm = opt.step({k: to_torch(v) for k, v in jg.items()})
        assert gnorm.dtype == torch.bfloat16
        assert float(gnorm) == float(optax.global_norm(jg)), step
        for k in init:
            assert tp[k].dtype == torch.bfloat16
            want = to_torch(jp[k])
            if case == "rmsprop":
                assert ulps(tp[k], want) <= 1, (step, k)
            else:
                assert torch.equal(tp[k], want), (step, k)
    for moments in (opt.mu, opt.nu):
        assert all(m.dtype == torch.bfloat16 for m in moments.values())
    assert opt.count == 5


def test_split_leaf_norm_equals_the_whole_leaf():
    """A vocab leaf split over a mesh row (``name#j``) counts in the
    global norm as the whole leaf does: partial sums in float32, one
    rounding."""
    g = torch.randn(40, 32, generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    b = torch.randn(7).bfloat16()
    whole = tsteps.global_norm({"logit_w": g, "lstm0_b": b})
    split = tsteps.global_norm({"logit_w#0": g[:20], "logit_w#1": g[20:],
                                "lstm0_b": b})
    assert whole.dtype == split.dtype == torch.bfloat16
    assert torch.equal(whole, split)


# ------------------------------------------------- XE and PG updates

def _xe_reference(jc, jb, params):
    """The reference's jitted XE step on ``params`` run with
    :func:`capture`: (loss, its gradients)."""
    jm = jax_model_from_config(jc)
    state = jsteps.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, params),
        tx=capture())
    new, metrics = jsteps.make_xe_train_step(jm)(
        state, jb.feats, jb.feat_masks, jb.captions, jb.weights, None,
        jb.video_idx, jax.random.PRNGKey(1), 0.0)
    return float(metrics["loss"]), dict(new.opt_state["params"])


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("fusion", FUSIONS)
def test_xe_step_on_bf16_leaves_under_the_witness(fusion, cdt):
    jc, tc = cfgs(fusion, "bfloat16", cdt)
    _, _, jb, tb = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    want_loss, want_grads = _xe_reference(jc, jb, init)
    tm = load_params(model_from_config(tc, device="cpu"), init)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = Recording(dict(tm.named_parameters()), tc.train, 4)
    out = tsteps.make_xe_train_step(tm, opt)(
        tb.feats, tb.feat_masks, tb.captions, tb.weights, None,
        tb.video_idx, None, 0.0)
    np.testing.assert_allclose(float(out["loss"]), want_loss, rtol=1e-5)
    assert out["grad_norm"].dtype == torch.bfloat16
    hold_grads(opt.seen, want_grads, GRAD_TIER[cdt], f"XE {fusion} {cdt}")
    update_witness(jsteps.make_optimizer(jc.train, 4), before, opt.seen,
                   dict(tm.state_dict()))
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    assert {m.dtype for m in opt.mu.values()} == {torch.bfloat16}


def pg_inputs(R, L, V, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(4, V, (R, L)).astype(np.int32)
    ends = rng.randint(2, L + 1, R)
    for r, e in enumerate(ends):
        tokens[r, e - 1] = 2     # EOS
        tokens[r, e:] = 0
    mask = (np.arange(L)[None, :] < ends[:, None]).astype(np.float32)
    adv = rng.randn(R).astype(np.float32)
    return tokens, mask, adv


def pg_reference(jc, jb, params, S, tokens, mask, adv):
    """The reference's ``_pg_update`` (jitted) on ``params`` run with
    :func:`capture`: (loss, norm, its gradients)."""
    jm = jax_model_from_config(jc)
    state = jsteps.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, params),
        tx=capture())
    cat = None if jb.category is None else jnp.asarray(jb.category)
    state, loss, norm = jax.jit(
        lambda s, f, m, c, t, k, a: jcst._pg_update(
            s, f, m, c, S, t, k, a, jc.train.sample_temperature))(
        state, {k: jnp.asarray(v) for k, v in jb.feats.items()},
        {k: jnp.asarray(v) for k, v in jb.feat_masks.items()}, cat,
        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(adv))
    return float(loss), float(norm), dict(state.opt_state["params"])


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("fusion", FUSIONS)
def test_pg_update_on_bf16_leaves_under_the_witness(fusion, cdt):
    jc, tc = cfgs(fusion, "bfloat16", cdt)
    _, _, jb, tb = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    S = 2
    tokens, mask, adv = pg_inputs(jc.data.batch_size * S, 8,
                                  jc.model.vocab_size, 11)
    want_loss, _, want_grads = pg_reference(jc, jb, init, S, tokens, mask,
                                            adv)
    tm = load_params(model_from_config(tc, device="cpu"), init)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = Recording(dict(tm.named_parameters()), tc.train, 1)
    loss, gnorm = tcst._pg_update(
        tm, opt, tb.feats, tb.feat_masks, S, torch.from_numpy(tokens),
        torch.from_numpy(mask), torch.from_numpy(adv),
        tc.train.sample_temperature)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert gnorm.dtype == torch.bfloat16
    hold_grads(opt.seen, want_grads, GRAD_TIER[cdt], f"PG {fusion} {cdt}")
    update_witness(jsteps.make_optimizer(jc.train, 1), before, opt.seen,
                   dict(tm.state_dict()))
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}


def _update_ulps(pdt: str) -> int:
    """The update witness's tier for leaves in ``pdt``: two float16 ulps
    on float16 leaves (the reading: the few elements left finite, whose
    first Adam update rounds near ``lr``, read up to two ulps apart from
    XLA's float16 chain; the non-finite ones sit at the same places); 4
    float32 ulps on float32 ones (the chain's norm sums in XLA's
    order)."""
    return 4 if pdt == "float32" else 2


@pytest.mark.parametrize("pdt", ["float32", "float16"])
@pytest.mark.parametrize("fusion", FUSIONS)
def test_xe_step_at_f16_compute_under_the_witness(fusion, pdt):
    jc, tc = cfgs(fusion, pdt, "float16")
    _, _, jb, tb = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    want_loss, want_grads = _xe_reference(jc, jb, init)
    tm = load_params(model_from_config(tc, device="cpu"), init)
    assert tm.compute_dtype == torch.float16
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = Recording(dict(tm.named_parameters()), tc.train, 4)
    out = tsteps.make_xe_train_step(tm, opt)(
        tb.feats, tb.feat_masks, tb.captions, tb.weights, None,
        tb.video_idx, None, 0.0)
    np.testing.assert_allclose(float(out["loss"]), want_loss, rtol=1e-5)
    assert out["grad_norm"].dtype == TORCH_DT[pdt]
    hold_grads(opt.seen, want_grads, GRAD_TIER["float16"],
               f"XE {fusion} f16 compute, {pdt} leaves")
    update_witness(jsteps.make_optimizer(jc.train, 4), before, opt.seen,
                   dict(tm.state_dict()), ulp=_update_ulps(pdt))
    assert {p.dtype for p in tm.parameters()} == {TORCH_DT[pdt]}


@pytest.mark.parametrize("pdt", ["float32", "float16"])
@pytest.mark.parametrize("fusion", FUSIONS)
def test_pg_update_at_f16_compute_under_the_witness(fusion, pdt):
    jc, tc = cfgs(fusion, pdt, "float16")
    _, _, jb, tb = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    S = 2
    tokens, mask, adv = pg_inputs(jc.data.batch_size * S, 8,
                                  jc.model.vocab_size, 11)
    want_loss, _, want_grads = pg_reference(jc, jb, init, S, tokens, mask,
                                            adv)
    tm = load_params(model_from_config(tc, device="cpu"), init)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = Recording(dict(tm.named_parameters()), tc.train, 1)
    loss, gnorm = tcst._pg_update(
        tm, opt, tb.feats, tb.feat_masks, S, torch.from_numpy(tokens),
        torch.from_numpy(mask), torch.from_numpy(adv),
        tc.train.sample_temperature)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert gnorm.dtype == TORCH_DT[pdt]
    hold_grads(opt.seen, want_grads, GRAD_TIER["float16"],
               f"PG {fusion} f16 compute, {pdt} leaves")
    update_witness(jsteps.make_optimizer(jc.train, 1), before, opt.seen,
                   dict(tm.state_dict()), ulp=_update_ulps(pdt))


@pytest.mark.parametrize("fusion", FUSIONS)
def test_float64_compute_builds_float32_and_warns_once(fusion):
    jc, tc = cfgs(fusion, "float32", "float64")
    tc.model.vocab_size = 40
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tm = model_from_config(tc, device="cpu")
    said = [str(w.message) for w in seen
            if issubclass(w.category, UserWarning)
            and "compute_dtype" in str(w.message)]
    assert len(said) == 1 and "float64" in said[0] and "float32" in said[0]
    assert tm.compute_dtype == torch.float32
    # The reference names float64 and computes in float32 (no x64).
    assert jnp.asarray(0.0, jnp.dtype(jc.model.compute_dtype)).dtype == \
        jnp.float32


def _device_error(fn):
    """The exception ``fn()`` raises (None if it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the test compares them)
        return type(e), str(e)
    return None


@pytest.mark.parametrize("serving_dtype", [None, "f32"])
def test_attention_at_f16_is_refused_for_a_cuda_device(serving_dtype):
    """Attention at float16 compute has its kernels now: no dtype gate
    stands before a CUDA device (the port's ``check_compute_dtype`` and
    ``AttentionFloat16Error`` are gone).  For ``cuda`` the model meets
    exactly what bfloat16 attention meets (on a host with a card it
    builds; on this one both stop at the device with the same error),
    and on the CPU it builds at float16; the bf16 serving override still
    forces bfloat16."""
    from cst_captioning_torch.ops import decode_common

    assert not hasattr(tcap, "check_compute_dtype")
    assert not hasattr(decode_common, "AttentionFloat16Error")
    _, tc = cfgs("attention", "float32", "float16")
    tc.model.vocab_size = 40
    _, tb = cfgs("attention", "float32", "bfloat16")
    tb.model.vocab_size = 40
    for kw in (dict(device="cuda"), {}):
        f16 = _device_error(lambda: model_from_config(
            tc, serving_dtype=serving_dtype, **kw))
        bf16 = _device_error(lambda: model_from_config(
            tb, serving_dtype=serving_dtype, **kw))
        assert f16 == bf16
    f16 = _device_error(lambda: tcap.CaptionModel(
        40, 32, 32, compute_dtype="float16", fusion="attention",
        device="cuda"))
    bf16 = _device_error(lambda: tcap.CaptionModel(
        40, 32, 32, compute_dtype="bfloat16", fusion="attention",
        device="cuda"))
    assert f16 == bf16
    tm = model_from_config(tc, serving_dtype=serving_dtype, device="cpu")
    assert tm.compute_dtype == torch.float16
    bf = model_from_config(tc, serving_dtype="bf16", device="cpu")
    assert bf.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
def test_per_step_loop_returns_each_leaf_its_cotangent(cdt):
    """The per-step loop (scheduled sampling's branch, a tensor
    ``ss_prob``: the context-attention Function on every step) on bf16
    leaves: every gradient in its leaf's dtype, and within the bf16
    compute tier of the fused branch's (the attention recurrence
    Function) at either compute dtype, since the loop rounds each step's
    cotangent of a leaf into bf16 and adds the steps' in bf16, where the
    fused branch rounds once."""
    jc, tc = cfgs("attention", "bfloat16", cdt)
    _, _, jb, tb = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    tm = load_params(model_from_config(tc, device="cpu"), init)
    names, params = zip(*tm.named_parameters())
    grads = {}
    for what, ss in (("fused", 0.0), ("per_step", torch.tensor(0.0))):
        loss = tsteps.xe_loss(tm, tb.feats, tb.feat_masks, tb.captions,
                              tb.weights, None, ss)
        grads[what] = dict(zip(names, torch.autograd.grad(loss, params)))
    for k, g in grads["per_step"].items():
        assert g.dtype == torch.bfloat16, k
    hold_grads(grads["per_step"],
               {k: v.float().numpy().astype(ml_dtypes.bfloat16)
                for k, v in grads["fused"].items()},
               GRAD_TIER["bfloat16"], f"per-step vs fused {cdt}")


def test_decode_operands_are_copies_that_follow_updates():
    """At a bf16 compute dtype a bf16 leaf needs no cast, yet the decode
    kernels' staged operands are copies (no alias of a leaf the update
    rewrites in place), rebuilt after an update."""
    _, tc = cfgs("attention")
    tc.model.vocab_size = 40
    tm = model_from_config(tc, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    kw = tm._kernel_weights()
    leaves = {p.data_ptr() for p in tm.parameters()}
    assert all(w.data_ptr() not in leaves for w in kw + tm._kw_layers
               if w is not None)
    opt = tsteps.make_optimizer(tc.train, 1, dict(tm.named_parameters()))
    opt.step({k: torch.ones_like(p) for k, p in tm.named_parameters()})
    kw2 = tm._kernel_weights()
    assert kw2 is not kw
    assert torch.equal(kw2[3], tm.logit_w.detach())
    assert not torch.equal(kw[3], kw2[3])


# ---------------------------------------------- bridge and checkpoints

@pytest.mark.parametrize("pdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("fusion", FUSIONS)
def test_bridge_round_trip_is_bitwise(fusion, pdt):
    jc, tc = cfgs(fusion, pdt)
    _, _, jb, _ = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    tm = load_params(model_from_config(tc, device="cpu"), init)
    back = state_dict_to_params(tm.state_dict())["params"]
    for k, v in init["params"].items():
        assert back[k].dtype == np.float32
        got = np.asarray(jnp.asarray(back[k], JAX_DT[pdt]))
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got.view(np.uint16),
                                      v.view(np.uint16), err_msg=k)
    again = load_params(model_from_config(tc, device="cpu"),
                        {"params": back})
    for k, v in tm.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def _one_xe_step(tm, opt, tb):
    return tsteps.make_xe_train_step(tm, opt)(
        tb.feats, tb.feat_masks, tb.captions, tb.weights, None,
        tb.video_idx, None, 0.0)


def test_save_restore_resume_is_bitwise(tmp_path):
    jc, tc = cfgs("attention")
    _, _, _, tb = first_batches(jc, tc)
    tm = model_from_config(tc, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    opt = tsteps.make_optimizer(tc.train, 4, dict(tm.named_parameters()))
    _one_xe_step(tm, opt, tb)
    tckpt.save_checkpoint(str(tmp_path / "last"), tm, opt, {"epoch": 0})
    raw = torch.load(tmp_path / "last" / "opt.pt", weights_only=True)
    assert {v.dtype for v in raw["mu"].values()} == {torch.bfloat16}
    other = model_from_config(tc, device="cpu")
    o2 = tsteps.make_optimizer(tc.train, 4, dict(other.named_parameters()))
    assert tckpt.restore_checkpoint(str(tmp_path / "last"), other, o2) == 1
    for a, b in ((tm.state_dict(), other.state_dict()), (opt.mu, o2.mu),
                 (opt.nu, o2.nu)):
        for k in a:
            assert a[k].dtype == torch.bfloat16
            assert torch.equal(a[k], b[k]), k
    _one_xe_step(tm, opt, tb)
    _one_xe_step(other, o2, tb)
    for k, v in tm.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


def test_float32_checkpoint_warm_starts_as_orbax_restores(tmp_path):
    """A float32 checkpoint warm-started into a bf16 model: bitwise the
    JAX package's orbax restore of its float32 checkpoint into a bf16
    template."""
    jc32, tc32 = cfgs("meanpool", "float32", "float32")
    _, _, jb, _ = first_batches(jc32, tc32)
    jm32 = jax_model_from_config(jc32)
    state = jsteps.create_train_state(jax.random.PRNGKey(4), jm32,
                                      jsteps.make_optimizer(jc32.train, 4),
                                      jb._asdict())
    # Spread the values so that many round to a tie-free neighbour and
    # some sit on exact bf16 midpoints.
    params = jax.tree.map(lambda x: x * 3.0, state.params)
    state = state.replace(params=params)
    jckpt.save_checkpoint(str(tmp_path / "jax"), state)
    jc16, tc16 = cfgs("meanpool", "bfloat16", "float32")
    jc16.model.vocab_size = tc16.model.vocab_size = jc32.model.vocab_size
    template = jax_init(jax_model_from_config(jc16), jb)
    want = jckpt.restore_params(str(tmp_path / "jax"), template)["params"]
    t32 = load_params(model_from_config(tc32, device="cpu"),
                      jax.tree.map(np.array, params))
    tckpt.save_checkpoint(str(tmp_path / "port"), t32,
                          tsteps.make_optimizer(
                              tc32.train, 4, dict(t32.named_parameters())))
    t16 = tckpt.restore_params(str(tmp_path / "port"),
                               model_from_config(tc16, device="cpu"))
    for k, v in want.items():
        got = t16.state_dict()[k]
        assert got.dtype == torch.bfloat16 and v.dtype == jnp.bfloat16
        assert torch.equal(got, to_torch(v)), k


@pytest.mark.parametrize("calibration", ["absmax", "percentile"])
@pytest.mark.parametrize("pdt", ["bfloat16", "float16"])
def test_quantize_params_from_low_precision_leaves(pdt, calibration):
    jc, tc = cfgs("attention", pdt)
    _, _, jb, _ = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    want = jq.quantize_params(jax.tree.map(jnp.asarray, init),
                              calibration)["params"]
    tm = load_params(model_from_config(tc, device="cpu"), init)
    got = tq.quantize_params(tm.state_dict(), calibration)
    assert port_dtype_names(got) == dtype_names(want)
    for k, v in want.items():
        assert torch.equal(got[k], to_torch(v)), k
    assert tq.scale_hashes(got) == jq.scale_hashes({"params": want})


def test_jax_checkpoint_with_bf16_leaves_imports_bitwise(tmp_path):
    """A JAX run trained with bf16 leaves (one XE step, orbax), exported
    by ``scripts/export_jax_checkpoint.py`` (exact float32 widenings)
    and imported with ``--model.param_dtype bfloat16``: the port's
    leaves are the trained ones, bitwise."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint",
        os.path.join(REPO, "scripts", "export_jax_checkpoint.py"))
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    over = ["--preset", "synthetic_smoke", "--model.param_dtype",
            "bfloat16", "--model.compute_dtype", "bfloat16"]
    jc = jcfg.parse_cli(over)
    ds, vocab = jbuild.build_dataset(jc, "train")
    jc.model.vocab_size = len(vocab)
    b = next(iter(jloader.BatchIterator(
        ds, batch_size=jc.data.batch_size, seq_per_img=jc.data.seq_per_img,
        max_frames=jc.data.max_frames, seed=1).epoch(0)))
    jm = jax_model_from_config(jc)
    state = jsteps.create_train_state(jax.random.PRNGKey(0), jm,
                                      jsteps.make_optimizer(jc.train, 2),
                                      b._asdict())
    state, _ = jsteps.make_xe_train_step(jm)(
        state, b.feats, b.feat_masks, b.captions, b.weights, None,
        b.video_idx, jax.random.PRNGKey(1), 0.0)
    trained = jax.tree.map(np.array, state.params)["params"]
    jckpt.save_checkpoint(str(tmp_path / "orbax"), state, {"epoch": 0})
    assert exporter.main(["--checkpoint", str(tmp_path / "orbax"), "--out",
                          str(tmp_path / "export")] + over) == 0
    assert importer.main(["--export", str(tmp_path / "export"), "--out",
                          str(tmp_path / "port")] + over) == 0
    got = tckpt.load_params_file(str(tmp_path / "port"))
    assert port_dtype_names(got) == dtype_names(trained)
    for k, v in trained.items():
        assert torch.equal(got[k], to_torch(v)), k


@pytest.mark.parametrize("fusion", FUSIONS)
def test_draft_from_bf16_leaves_reads_host_float32(fusion):
    """The speculative draft's truncation init from bf16 leaves (a port
    state dict, and the JAX tree itself) equals the reference's, which
    reads each leaf as host float32."""
    jc, tc = cfgs(fusion)
    _, _, jb, _ = first_batches(jc, tc)
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    want = jspec.make_draft_params(init, 16)
    tm = load_params(model_from_config(tc, device="cpu"), init)
    for src in (tm.state_dict(), init):
        got = tspec.make_draft_params(src, 16)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _bf16_fit(tmp_path, name, max_epochs, resume=False, start_from="",
              pdt="bfloat16"):
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.param_dtype = pdt
    cfg.model.compute_dtype = "bfloat16"
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.train.max_epochs = max_epochs
    cfg.train.resume = resume
    cfg.train.start_from = start_from
    cfg.name = name
    tr, vocab = tbuild.build_dataset(cfg, "train")
    va, _ = tbuild.build_dataset(cfg, "val", vocab=vocab)
    t = Trainer(cfg, tr, va, device="cpu")
    return t, t.fit() if max_epochs else None


def test_trainer_keep_best_resume_and_warm_start_on_bf16_leaves(tmp_path):
    """The ``Trainer`` with bf16 leaves: its best / last checkpoints hold
    bf16 leaves and moments; a run resumed after epoch 1 of 2 ends
    bitwise the uninterrupted run; a stage warm-started from a float32
    run's checkpoint starts from its leaves rounded to bf16."""
    full, hist = _bf16_fit(tmp_path, "full", 2)
    assert {p.dtype for p in full.model.parameters()} == {torch.bfloat16}
    for d in ("best", "last"):
        sd = tckpt.load_params_file(os.path.join(full.workdir, d))
        assert {v.dtype for v in sd.values()} == {torch.bfloat16}
    _bf16_fit(tmp_path, "split", 1)
    resumed, hist2 = _bf16_fit(tmp_path, "split", 2, resume=True)
    assert resumed.start_epoch == 1
    assert hist2["1"]["train_loss"] == hist["1"]["train_loss"]
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for a, b in ((full.optimizer.mu, resumed.optimizer.mu),
                 (full.optimizer.nu, resumed.optimizer.nu)):
        for k, v in a.items():
            assert b[k].dtype == torch.bfloat16 and torch.equal(b[k], v), k
    f32, _ = _bf16_fit(tmp_path, "xe32", 1, pdt="float32")
    warm, _ = _bf16_fit(tmp_path, "wxe16", 0,
                        start_from=os.path.join(f32.workdir, "last"))
    for k, v in f32.model.state_dict().items():
        got = warm.model.state_dict()[k]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, v.to(torch.bfloat16)), k
    assert warm.optimizer.count == 0


@pytest.mark.parametrize("rollout", ["scan", "padded", "slot"])
def test_cst_steps_on_bf16_leaves(rollout):
    """The CST split step (``scan``: the chunked fused-sampler rollout)
    and the padded / slot steps on bf16 leaves: finite metrics, the
    leaves and moments bf16 after the update, and the leaves moved."""
    jc, tc = cfgs("meanpool")
    tc.train.train_mode = "cst"
    tc.train.cst_baseline = "scb"
    tc.train.cst_num_samples = 2
    tc.train.cst_rollout = rollout
    tc.model.use_pallas_sampler = rollout == "scan"
    _, tds, _, tb = first_batches(jc, tc)
    tm = model_from_config(tc, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = tsteps.make_optimizer(tc.train, 1, dict(tm.named_parameters()))
    m = tcst.make_cst_train_step(tm, opt, tc, tds)(
        tb.feats, tb.feat_masks, None, None, None, tb.video_idx,
        torch.Generator().manual_seed(3), 0.0)
    for k in ("loss", "grad_norm", "reward", "baseline"):
        assert np.isfinite(float(m[k])), k
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    assert {v.dtype for v in opt.nu.values()} == {torch.bfloat16}
    assert any(not torch.equal(v, tm.state_dict()[k])
               for k, v in before.items())


def test_artifact_of_bf16_leaves_boots_bitwise_the_warm_engine(tmp_path):
    """An engine on bf16 leaves published as a serving artifact: the
    manifest keeps the reference's fields (plus ``kernels``), the boot
    runs no nvcc, its leaves are bf16, and its slot loop's tokens and
    scores are bitwise the warm engine's."""
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.serving import artifact as tart

    from test_torch_artifact import REFERENCE_KEYS, _boot, _publish
    from test_torch_slots import N_REQ as N_SLOT_REQ
    from test_torch_slots import _cfg as _slot_cfg
    from test_torch_slots import _drive
    from test_torch_slots import _payloads as _slot_payloads

    cfg = _slot_cfg(get_preset, "meanpool", "beam")
    cfg.model.param_dtype = "bfloat16"
    vocab = Vocabulary([f"w{i}" for i in range(40)])
    init = InferenceEngine(cfg, random_init=True, vocab=vocab, device="cpu")
    sd = {k: v.clone() for k, v in init.model.state_dict().items()}
    sd["word_embed"] *= 10.0
    sd["lstm0_w"] *= 2.0
    sd["logit_w"] *= 3.0
    warm = InferenceEngine(init.cfg, params=sd, vocab=vocab, device="cpu")
    path = _publish(warm, tmp_path)
    assert set(tart.load_manifest(path)) == REFERENCE_KEYS | {"kernels"}
    booted = _boot(path)
    assert {p.dtype for p in booted.model.parameters()} == {torch.bfloat16}
    got_w = _drive(warm.slot_decoder(), [warm.prepare(p) for p in
                                         _slot_payloads()],
                   range(N_SLOT_REQ))
    got_b = _drive(booted.slot_decoder(), [booted.prepare(p) for p in
                                           _slot_payloads()],
                   range(N_SLOT_REQ))
    for i in range(N_SLOT_REQ):
        np.testing.assert_array_equal(got_b[i][0], got_w[i][0])
        assert got_b[i][1] == got_w[i][1]


# ------------------------------------------------------------------ mesh

def _mesh_world(tmp_path=None):
    jc, tc = cfgs("meanpool", "bfloat16", "float32")
    _, _, jb, tb = first_batches(jc, tc)
    V = (jc.model.vocab_size + 3) // 4 * 4
    jc.model.vocab_size = tc.model.vocab_size = V
    init = jax.tree.map(np.array, jax_init(jax_model_from_config(jc), jb))
    return tc, tb, init


def test_2x2_mesh_step_on_bf16_leaves(tmp_path):
    tc, tb, init = _mesh_world()
    args = (tb.feats, tb.feat_masks, tb.captions, tb.weights, None,
            tb.video_idx, None, 0.0)
    one = load_params(model_from_config(tc, device="cpu"), init)
    before = {k: v.clone() for k, v in one.state_dict().items()}
    opt1 = Recording(dict(one.named_parameters()), tc.train, 10)
    out1 = tsteps.make_xe_train_step(one, opt1)(*args)
    template = load_params(model_from_config(tc, device="cpu"), init)
    mm = sharded.MeshModel(tc, make_mesh({"data": 2, "model": 2},
                                         devices=["cpu"] * 4), template)
    assert mm.split
    opt2 = sharded.MeshOptimizer(mm, tc.train, 10)
    seen = {}
    real = opt2.step

    def spy(grads):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return real(grads)

    opt2.step = spy
    out2 = sharded.make_mesh_xe_train_step(mm, opt2)(*args)
    np.testing.assert_allclose(float(out2["loss"]), float(out1["loss"]),
                               rtol=1e-5)
    folded = opt2._gather(seen)
    hold_grads(folded, {k: v.float().numpy().astype(ml_dtypes.bfloat16)
                        for k, v in opt1.seen.items()},
               MESH_FOLD_TIER, "2x2 mesh folded gradients")
    for g in seen.values():
        assert g.dtype == torch.bfloat16
    # The update witness: the one-device optimizer fed the mesh's
    # folded gradients is the mesh's update, bitwise.
    ref = load_params(model_from_config(tc, device="cpu"),
                      {"params": before})
    tsteps.make_optimizer(tc.train, 10, dict(ref.named_parameters())).step(
        folded)
    got = mm.gathered_state_dict()
    for k, v in ref.state_dict().items():
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], v), k
    for d in range(1, mm.D):
        for (k, a), (_, b) in zip(mm.named_tensors(0), mm.named_tensors(d)):
            assert torch.equal(a, b), k
    # Its checkpoint gathered and resharded onto a fresh (2, 2) mesh.
    tckpt.save_checkpoint(str(tmp_path / "mesh"), mm, opt2)
    mm2 = sharded.MeshModel(tc, make_mesh({"data": 2, "model": 2},
                                          devices=["cpu"] * 4),
                            model_from_config(tc, device="cpu"))
    o2 = sharded.MeshOptimizer(mm2, tc.train, 10)
    tckpt.restore_checkpoint(str(tmp_path / "mesh"), mm2, o2)
    back = mm2.gathered_state_dict()
    for k, v in got.items():
        assert back[k].dtype == torch.bfloat16
        assert torch.equal(back[k], v), k
    want_opt, got_opt = opt2.state_dict(), o2.state_dict()
    for part in ("mu", "nu"):
        for k, v in want_opt[part].items():
            assert got_opt[part][k].dtype == torch.bfloat16
            assert torch.equal(got_opt[part][k], v), (part, k)


WORKER = r"""
import sys, torch
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from cst_captioning_torch.parallel import distributed, make_mesh
from cst_captioning_torch.training import sharded
sys.path.insert(0, "tests")
from test_torch_param_dtype import bf16_model_and_batches
distributed.ensure_initialized(f"tcp://localhost:{port}", world, rank,
                               backend="gloo")
cfg, model, batches = bf16_model_and_batches(rank, world)
mm = sharded.MeshModel(cfg, make_mesh({"data": 1, "model": 1}, ["cpu"]),
                       model)
b = batches[0]
m = sharded.make_mesh_xe_train_step(
    mm, sharded.MeshOptimizer(mm, cfg.train, 10))(
    b.feats, b.feat_masks, b.captions, b.weights, None, b.video_idx, None,
    0.0)
torch.save({"params": mm.gathered_state_dict(), "loss": float(m["loss"])},
           out)
"""


def bf16_model_and_batches(rank: int, world: int):
    """``tests/test_torch_distributed.py``'s smoke model and process
    shard, with bf16 leaves."""
    from test_torch_distributed import _model_and_batches

    cfg, model, batches = _model_and_batches(rank, world)
    cfg.model.param_dtype = "bfloat16"
    low = model_from_config(cfg, device="cpu")
    low.load_state_dict(model.state_dict())
    return cfg, low, batches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_the_2x1_mesh_on_bf16_leaves(tmp_path):
    """Each process's bf16 gradients all-reduced in bf16 by gloo: with
    two processes one bf16 add, the (2, 1) mesh's shard-order fold, so
    the leaves are bitwise the single-process mesh step's."""
    port = str(_free_port())
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "2",
                               port, outs[r]], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(o, weights_only=False) for o in outs]
    cfg, model, b0 = bf16_model_and_batches(0, 2)
    _, _, b1 = bf16_model_and_batches(1, 2)
    a, b = b0[0], b1[0]
    cat = lambda x, y: (None if x is None else  # noqa: E731
                        {k: torch.cat([x[k], y[k]]) for k in x}
                        if isinstance(x, dict) else torch.cat([x, y]))
    mm = sharded.MeshModel(cfg, make_mesh({"data": 2, "model": 1},
                                          ["cpu"] * 2), model)
    m = sharded.make_mesh_xe_train_step(
        mm, sharded.MeshOptimizer(mm, cfg.train, 10))(
        cat(a.feats, b.feats), cat(a.feat_masks, b.feat_masks),
        cat(a.captions, b.captions), cat(a.weights, b.weights), None,
        cat(a.video_idx, b.video_idx), None, 0.0)
    want = mm.gathered_state_dict()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        for k, v in want.items():
            assert r["params"][k].dtype == torch.bfloat16
            assert torch.equal(r["params"][k], v), k


# --------------------------------------------------------------- serving

def _serve_cfg(get, fusion, mode, dtype, continuous=False):
    c = _int8w_cfg(get, fusion, mode, dtype, continuous)
    c.model.param_dtype = "bfloat16"
    return c


def _spread(params, mode):
    """The random init spread so captions differ and end at varied steps
    (as tests/test_torch_int8w_serving.py spreads it), in float32, then
    rounded back to the bf16 leaves."""
    pp = {k: np.asarray(v).astype(np.float32)
          for k, v in jax.device_get(params)["params"].items()}
    pp["word_embed"] = pp["word_embed"] * 10.0
    pp["lstm0_w"] = pp["lstm0_w"] * 2.0
    pp["logit_w"] = pp["logit_w"] * 3.0
    pp["logit_b"][2] += 1.0 if mode == "beam" else 0.6
    return {"params": {k: v.astype(ml_dtypes.bfloat16)
                       for k, v in pp.items()}}


@pytest.mark.parametrize("mode", ["beam", "greedy"])
@pytest.mark.parametrize("fusion", FUSIONS)
def test_served_tokens_on_bf16_leaves_match_the_jax_engine(fusion, mode):
    base = JaxEngine(_serve_cfg(jcfg.get_preset, fusion, mode, "f32"),
                     random_init=True)
    assert {str(v.dtype) for v in jax.tree.leaves(base.params)} == {
        "bfloat16"}
    params = _spread(base.params, mode)
    vocab = Vocabulary(base.vocab.idx_to_word[4:])
    payloads = _payloads()
    for dtype in ("f32", "bf16", "int8w"):
        jeng = JaxEngine(_serve_cfg(jcfg.get_preset, fusion, mode, dtype),
                         params=jax.tree.map(jnp.asarray, params),
                         vocab=base.vocab)
        want = _ladder(jeng, payloads)
        eng = InferenceEngine(
            _serve_cfg(tcfg.get_preset, fusion, mode, dtype), params=params,
            vocab=vocab, device="cpu")
        leaves = port_dtype_names(eng.model.state_dict())
        assert set(leaves.values()) == (
            {"bfloat16", "int8", "float32"} if dtype == "int8w"
            else {"bfloat16"}), dtype
        if dtype == "int8w":
            assert tq.scale_hashes(eng.model.state_dict()) == \
                jq.scale_hashes(jeng.params)
        ladder = _ladder(eng, payloads)
        slots, _ = _slots(InferenceEngine(
            _serve_cfg(tcfg.get_preset, fusion, mode, dtype, True),
            params=params, vocab=vocab, device="cpu"), payloads)
        if dtype == "f32":
            assert _match(ladder, want) == 1.0
            assert _match(slots, want) == 1.0
        else:
            assert _match(ladder, want) >= RELAXED_SERVING_MATCH_FLOOR, dtype
            assert _match(slots, want) >= RELAXED_SERVING_MATCH_FLOOR, dtype
