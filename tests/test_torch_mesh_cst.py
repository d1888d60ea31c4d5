"""The CST step on a mesh: ``training/cst.py``'s split and slot steps on
``training/sharded.py::MeshPlacement`` against the port's one-device CST
step and the JAX package's PG update (``training/cst.py::_pg_update``,
which the JAX package's own tests hold equal to its sharded update).

Tier (docs/PARITY.md r12): the rollout's rewards, baseline and
advantage bitwise the one-device step's (each chunk's rows and seed
words are the one-device step's, and the sharded vocab columns are the
one-device columns); the loss within rtol 1e-5 and the parameters within
rtol 2e-5 / atol 1e-5 of both the one-device step and JAX's update on
the same tokens and advantage.  The port's meshes stand on repeated
``cpu`` devices.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cst_captioning_torch.parallel import make_mesh
from cst_captioning_torch.training import cst as tcst
from cst_captioning_torch.training import sharded
from cst_captioning_torch.training import steps as tsteps

from test_torch_cst import (  # noqa: F401  (corpora: a fixture)
    A,
    D1,
    D2,
    E,
    H,
    PHASES,
    S,
    V,
    _batch,
    _cfgs,
    _j,
    _jax_pg,
    _port_model,
    _run,
    corpora,
)


def _mesh_cfg(tc, fusion):
    """``tc`` with the model section of ``test_torch_cst._port_model``,
    so ``model_from_config`` builds the mesh's replicas as its twins."""
    c = tc.replace()
    c.model.vocab_size = V
    c.model.rnn_size = H
    c.model.input_encoding_size = E
    c.model.att_hidden_size = A
    c.model.feature_fusion = fusion
    c.model.compute_dtype = "float32"
    c.model.drop_prob = 0.0
    c.model.use_pallas_sampler = True
    c.data.feature_modalities = ["resnet", "c3d"]
    c.data.feature_dims = {"resnet": D1, "c3d": D2}
    return c


def _hold(got, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   rtol=2e-5, atol=1e-5, err_msg=f"{what} {k}")


CASES = [("meanpool", shape, baseline, "scan")
         for shape in ((2, 2), (1, 2), (2, 1))
         for baseline in ("scb", "greedy")] + [
    ("attention", (2, 2), "scb", "scan"),
    ("meanpool", (2, 2), "greedy", "slot"),
    ("meanpool", (2, 1), "scb", "padded"),
]


@pytest.mark.parametrize("fusion,shape,baseline,rollout", CASES)
def test_mesh_cst_step_matches_one_device_and_jax(fusion, shape, baseline,
                                                  rollout, corpora,
                                                  monkeypatch):
    pds = corpora[0]
    tc, _ = _cfgs(baseline, cst_rollout=rollout)
    seen = {}
    real = tcst._pg_update

    def spy(model, optimizer, feats, feat_masks, S_, tokens, mask, adv, *a):
        seen.update(tokens=tokens.numpy().copy(), mask=mask.numpy().copy(),
                    adv=adv.numpy().copy())
        return real(model, optimizer, feats, feat_masks, S_, tokens, mask,
                    adv, *a)

    monkeypatch.setattr(tcst, "_pg_update", spy)
    one = _port_model(fusion)
    opt = tsteps.make_optimizer(tc.train, 1, dict(one.named_parameters()))
    m1 = _run(tcst.make_cst_train_step(one, opt, tc, pds))
    assert seen, "the one-device step took another update"

    cfg = _mesh_cfg(tc, fusion)
    mesh = make_mesh({"data": shape[0], "model": shape[1]},
                     devices=["cpu"] * (shape[0] * shape[1]))
    mm = sharded.MeshModel(cfg, mesh, _port_model(fusion))
    assert mm.split == (shape[1] > 1)
    mopt = sharded.MeshOptimizer(mm, cfg.train, 1)
    step = sharded.make_mesh_cst_train_step(mm, mopt, cfg, pds)
    mesh_rows = []
    real_pg = sharded.pg_loss

    def pg_spy(rep, feats, feat_masks, S_, tokens, *a, **kw):
        mesh_rows.append(tokens.numpy().copy())
        return real_pg(rep, feats, feat_masks, S_, tokens, *a, **kw)

    monkeypatch.setattr(sharded, "pg_loss", pg_spy)
    m2 = _run(step)

    # The mesh ran the one split / slot step, its phases included.
    assert step.layout == ("split" if rollout == "scan"
                           else f"slot:{rollout}")
    if rollout == "scan":
        assert set(step.phase_ms) == PHASES | (
            {"greedy_fetch_ms"} if baseline == "greedy" else set())
    # One PG loss a data shard, on the one-device step's rows in order.
    assert len(mesh_rows) == shape[0]
    np.testing.assert_array_equal(np.concatenate(mesh_rows), seen["tokens"])
    for k in ("reward", "baseline", "advantage"):
        assert m2[k] == m1[k], k
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    got = mm.gathered_state_dict()
    _hold(got, {k: v.detach() for k, v in one.state_dict().items()},
          "vs the one-device step")

    state0, run = _jax_pg(fusion, 1.0)
    feats, masks = _batch()
    state, jloss, _ = run(state0, _j(feats), _j(masks),
                          jnp.asarray(seen["tokens"]),
                          jnp.asarray(seen["mask"]), jnp.asarray(seen["adv"]))
    np.testing.assert_allclose(float(m2["loss"]), float(jloss), rtol=1e-5)
    _hold(got, state.params["params"], "vs JAX's update")
    # Every data shard's replica holds the owners' values.
    for d in range(1, mm.D):
        for (k, a), (_, b) in zip(mm.named_tensors(0), mm.named_tensors(d)):
            assert torch.equal(a, b), k


def test_mesh_cst_use_gt_takes_the_mesh_wxe_step(corpora):
    tc, _ = _cfgs("none", cst_use_gt=True)
    cfg = _mesh_cfg(tc, "meanpool")
    mm = sharded.MeshModel(cfg, make_mesh({"data": 2, "model": 1},
                                          devices=["cpu"] * 2),
                           _port_model("meanpool"))
    step = sharded.make_mesh_cst_train_step(
        mm, sharded.MeshOptimizer(mm, cfg.train, 1), cfg, corpora[0])
    assert not hasattr(step, "phase_ms")
