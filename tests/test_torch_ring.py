"""Frame / sequence parallelism of the port (``parallel/ring.py``) and
the ``model.shard_frames`` captioner, against the JAX package's
(``tests/test_ring.py``) and the dense computation.

Tier: the reference's — rtol 2e-5 / atol 2e-6 against dense attention
and the JAX ring; the shard_frames model's logits rtol 2e-5 / atol 2e-5
against the JAX shard_frames model on the bridged parameters and
against the port's dense model, its gradients rtol 1e-4 / atol 1e-6,
its greedy tokens exact.  JAX runs on the forced CPU devices; the
port's meshes stand on repeated ``cpu`` devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_torch.config import get_preset as tpreset
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.parallel import make_mesh
from cst_captioning_torch.parallel.ring import (
    ring_attention,
    sharded_context_attention,
)
from cst_captioning_tpu.config import get_preset as jpreset
from cst_captioning_tpu.models import model_from_config as jmodel_from_config
from cst_captioning_tpu.parallel import make_mesh as jmake_mesh
from cst_captioning_tpu.parallel.ring import (
    ring_attention as jring_attention,
    sharded_context_attention as jsharded_context_attention,
)

TOL = dict(rtol=2e-5, atol=2e-6)


def _dense(q, k, v, mask):
    s = torch.einsum("bqh,bkh->bqk", q, k) / q.shape[-1] ** 0.5
    s = torch.where(mask[:, None, :] > 0, s, -1e30)
    return torch.einsum("bqk,bkh->bqh", torch.softmax(s, -1), v)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"data": 1, "model": 4}, devices=["cpu"] * 4)


@pytest.mark.parametrize("masked", [False, True])
def test_ring_attention_matches_dense_and_jax(mesh, masked):
    rng = np.random.RandomState(1 if masked else 0)
    B, S, H = 2, 64, 8
    q, k, v = (rng.randn(B, S, H).astype(np.float32) for _ in range(3))
    mask = ((rng.rand(B, S) > 0.3) if masked
            else np.ones((B, S))).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    got = ring_attention(*t[:3], mesh, kv_mask=t[3])
    torch.testing.assert_close(got, _dense(*t), **TOL)
    jmesh = jmake_mesh({"data": 1, "model": 4}, devices=jax.devices()[:4])
    want = jring_attention(*(jnp.asarray(x) for x in (q, k, v)), jmesh,
                           kv_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        # Masked keys cannot influence the output.
        v_pert = torch.where(t[3][..., None] > 0, t[2], 1e4)
        torch.testing.assert_close(
            ring_attention(t[0], t[1], v_pert, mesh, kv_mask=t[3]), got,
            **TOL)


@pytest.mark.parametrize("layout", ["frames", "frames_and_batch"])
def test_sharded_context_attention_matches_dense_and_jax(layout):
    rng = np.random.RandomState(3)
    B, F, E, A = 4, 32, 8, 12
    query, vals, proj = (rng.randn(*s).astype(np.float32)
                         for s in ((B, A), (B, F, E), (B, F, A)))
    att_v = rng.randn(A, 1).astype(np.float32)
    mask = np.ones((B, F), np.float32)
    mask[:, -5:] = 0.0
    t = [torch.from_numpy(x) for x in (query, vals, proj, mask, att_v)]
    s = (torch.tanh(t[2] + t[0][:, None, :]) @ t[4])[..., 0]
    a = torch.softmax(torch.where(t[3] > 0, s, -1e30), -1)
    dense = torch.einsum("bf,bfe->be", a, t[1])
    shape = {"data": 2, "model": 4} if layout == "frames_and_batch" else {
        "data": 1, "model": 4}
    n = shape["data"] * shape["model"]
    batch_axis = "data" if shape["data"] > 1 else None
    got = sharded_context_attention(
        t[0], t[1], t[2], t[3], t[4],
        make_mesh(shape, devices=["cpu"] * n), batch_axis=batch_axis)
    torch.testing.assert_close(got, dense, **TOL)
    want = jsharded_context_attention(
        *(jnp.asarray(x) for x in (query, vals, proj, mask, att_v)),
        jmake_mesh(shape, devices=jax.devices()[:n]), batch_axis=batch_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------ the shard_frames model

def _cfgs():
    out = []
    for get in (jpreset, tpreset):
        cfg = get("synthetic_smoke")
        cfg.model.feature_fusion = "attention"
        cfg.data.max_frames = 8
        cfg.model.vocab_size = 32
        out.append(cfg)
    return out


def _batch(cfg, rng):
    B, F = 4, cfg.data.max_frames
    D = cfg.data.feature_dims["resnet"]
    feats = rng.randn(B, F, D).astype(np.float32)
    masks = np.ones((B, F), np.float32)
    masks[:, -2:] = 0.0
    ids = rng.randint(4, cfg.model.vocab_size, (B, 10)).astype(np.int32)
    ids[:, 0] = 1
    return feats, masks, ids


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = _cfgs()
    feats, masks, ids = _batch(jcfg, np.random.RandomState(5))
    jdense = jmodel_from_config(jcfg)
    params = jdense.init(jax.random.PRNGKey(0), {"resnet": jnp.asarray(feats)},
                         {"resnet": jnp.asarray(masks)}, jnp.asarray(ids))
    jcfg.model.shard_frames = True
    jmesh = jmake_mesh({"data": 2, "model": 4}, devices=jax.devices()[:8])
    want = jmodel_from_config(jcfg, mesh=jmesh).apply(
        params, {"resnet": jnp.asarray(feats)}, {"resnet": jnp.asarray(masks)},
        jnp.asarray(ids))
    host = jax.tree.map(np.asarray, params)
    dense = model_from_config(tcfg, device="cpu")
    load_params(dense, host)
    tcfg.model.shard_frames = True
    mesh = make_mesh({"data": 2, "model": 4}, devices=["cpu"] * 8)
    sharded = model_from_config(tcfg, device="cpu", mesh=mesh)
    load_params(sharded, host)
    batch = ({"resnet": torch.from_numpy(feats)},
             {"resnet": torch.from_numpy(masks)},
             torch.from_numpy(ids).long())
    return dense, sharded, batch, np.asarray(want)


def test_shard_frames_forward_matches_jax_and_dense(world):
    dense, sharded, batch, want = world
    assert sharded.frame_mesh is not None
    assert sharded.frame_batch_axis == "data"
    with torch.no_grad():
        got = sharded(*batch, ss_prob=torch.tensor(0.0))
        ref = dense(*batch, ss_prob=torch.tensor(0.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


def test_shard_frames_gradients_match_dense(world):
    dense, sharded, batch, _ = world
    targets = torch.roll(batch[2], -1, dims=1)
    grads = []
    for m in (dense, sharded):
        m.zero_grad()
        logits = m(*batch, ss_prob=torch.tensor(0.0))
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)
        ).backward()
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-4,
                                   atol=1e-6, msg=k)


def test_shard_frames_sample_matches_dense(world):
    """The per-step decode (a sharded-frames model declines the fused
    decoders on its multi-device mesh) gives the dense model's greedy
    tokens."""
    dense, sharded, batch, _ = world
    a = dense._sample_from_cache(*dense.init_decode(*batch[:2]), max_len=8)
    b = sharded.sample(*batch[:2], max_len=8, greedy=True)
    assert torch.equal(a.tokens, b.tokens)
    torch.testing.assert_close(a.logprobs, b.logprobs, rtol=1e-4, atol=1e-5)
