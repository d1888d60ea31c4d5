"""The port's mesh and rule table (``parallel/mesh.py``,
``parallel/partition.py``, ``parallel/sharding.py``,
``parallel/collectives.py``) against the JAX package's
(``tests/test_partition.py::TestMeshValidation`` and the rule-table
tests).  Tier: exact — validations raise the reference's messages, the
rule tables are equal, a reshard is bitwise, the collectives' results
equal the unsharded computation (the log-softmax at 1e-6).  The port's
meshes stand on repeated ``cpu`` devices.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from cst_captioning_torch.config import get_preset
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.parallel import (
    VocabShardedLogits,
    embedding_rows,
    gather_tree,
    make_mesh,
    mesh_from_config,
    mesh_shape_str,
    partition,
    shard_tree,
    submesh_groups,
    token_logprobs,
)
from cst_captioning_tpu.parallel import partition as jpartition

CPU4 = ["cpu"] * 4
CPU8 = ["cpu"] * 8
REPO = __file__.rsplit("/tests/", 1)[0]


# ----------------------------------------------------------- validation

def test_non_divisible_wildcard_names_axes():
    with pytest.raises(ValueError, match="cannot absorb"):
        make_mesh({"data": -1, "model": 3}, devices=CPU8)


def test_oversized_mesh_names_shape():
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh({"data": 4, "model": 4}, devices=CPU8)


def test_zero_axis_rejected():
    with pytest.raises(ValueError, match="must be positive"):
        make_mesh({"data": 0, "model": 2}, devices=CPU8)


def test_empty_shape_rejected():
    with pytest.raises(ValueError, match="empty"):
        make_mesh({}, devices=CPU8)


def test_two_wildcards_rejected():
    with pytest.raises(ValueError, match="at most one -1"):
        make_mesh({"data": -1, "model": -1}, devices=CPU8)


def test_no_devices_never_falls_back_to_the_cpu():
    """Without a device list the mesh counts the host's cards and never
    repeats one; with none it refuses instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has cards")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh({"data": -1, "model": 1})
    with pytest.raises(ValueError, match="no devices"):
        make_mesh({"data": -1, "model": 1}, devices=[])


def test_deterministic_device_order():
    devs = [torch.device("cuda", i) for i in range(4)]
    a = make_mesh({"data": 2, "model": 2}, devices=devs)
    b = make_mesh({"data": 2, "model": 2}, devices=list(reversed(devs)))
    assert list(a.devices.flat) == list(b.devices.flat) == devs
    assert a.model_row(1) == devs[2:]


def test_mesh_shape_str_and_submesh_groups():
    assert mesh_shape_str(make_mesh({"data": 2, "model": 4},
                                    devices=CPU8)) == "2x4"
    assert mesh_shape_str(None) == "1x1"
    devs = [torch.device("cuda", i) for i in range(5)]
    a = submesh_groups(devs, 2)
    b = submesh_groups(list(reversed(devs)), 2)
    assert a == b == [devs[0:2], devs[2:4]]
    with pytest.raises(ValueError, match="group size"):
        submesh_groups(devs, 0)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_default_mesh_shape_resolves_over_every_device_given(n):
    """``train.mesh_shape = {"data": -1, "model": 1}`` (the default of
    both packages) takes every device ``mesh_from_config`` is given, as
    the reference resolves -1 over all devices; the trainer resolves its
    mesh through it."""
    cfg = get_preset("synthetic_smoke")
    assert cfg.train.mesh_shape == {"data": -1, "model": 1}
    mesh = mesh_from_config(cfg, ["cpu"] * n)
    assert mesh.shape == {"data": n, "model": 1} and mesh.size == n


def test_trainer_trains_over_every_device_given(tmp_path):
    from cst_captioning_torch.data.build import build_dataset
    from cst_captioning_torch.training.trainer import Trainer

    cfg = get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = str(tmp_path)
    ds, _ = build_dataset(cfg, "train")
    tr = Trainer(cfg, ds, devices=["cpu"] * 4)
    assert tr.mesh.shape == {"data": 4, "model": 1}
    assert tr.mesh_model is not None and len(tr.mesh_model.replicas) == 4


# ----------------------------------------------------------- rule table

def test_rule_tables_equal_the_reference():
    assert partition.PARTITION_RULES == jpartition.PARTITION_RULES
    assert partition.KNOWN_PARAM_LEAVES == jpartition.KNOWN_PARAM_LEAVES
    for leaf in partition.KNOWN_PARAM_LEAVES:
        assert partition.spec_for_leaf(leaf) == tuple(
            jpartition.spec_for_leaf(leaf))


def test_strict_raises_on_unknown_and_ambiguous():
    with pytest.raises(ValueError, match="no partition rule"):
        partition.spec_for_leaf("mystery_tensor_w")
    dbl = ((r"embed$", ()), (r"word_embed$", ("model", None)))
    with pytest.raises(ValueError, match="matches 2"):
        partition.spec_for_leaf("word_embed",
                                rules=partition.compiled_rules(dbl))


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_rules_cover_the_model_and_the_adam_moments(fusion):
    """Every leaf of a real model matches exactly one rule, and the same
    table specs the optimizer's moments; the update count is
    unpartitioned."""
    from cst_captioning_torch.training.steps import make_optimizer

    cfg = get_preset("synthetic_smoke")
    cfg.model.feature_fusion = fusion
    cfg.model.use_category = True
    cfg.model.vocab_size = 40
    model = model_from_config(cfg, device="cpu")
    opt = make_optimizer(cfg.train, 10, dict(model.named_parameters()))
    specs = partition.match_partition_rules(
        partition.PARTITION_RULES,
        {"params": model.state_dict(), "opt": opt.state_dict()})
    assert set(model.state_dict()) <= set(partition.KNOWN_PARAM_LEAVES)
    assert specs["params/word_embed"] == ("model", None)
    assert specs["params/logit_w"] == (None, "model")
    assert specs["opt/mu/word_embed"] == specs["opt/nu/word_embed"] == (
        "model", None)
    assert specs["opt/mu/logit_b"] == ("model",)
    assert specs["opt/count"] == ()


def test_divisibility_fallback():
    mesh = make_mesh({"data": 2, "model": 4}, devices=CPU8)
    tree = {"word_embed": torch.zeros(10, 8),   # 10 % 4 != 0 -> ()
            "logit_w": torch.zeros(8, 16)}       # 16 % 4 == 0 -> sharded
    specs = partition.tree_specs(tree, mesh)
    assert specs == {"word_embed": (), "logit_w": (None, "model")}


def test_shard_and_gather_are_bitwise_and_unaliased():
    mesh = make_mesh({"data": 2, "model": 2}, devices=CPU4)
    g = torch.Generator().manual_seed(0)
    tree = {"word_embed": torch.randn(8, 3, generator=g),
            "logit_w": torch.randn(3, 8, generator=g),
            "lstm0_b": torch.randn(12, generator=g)}
    placed = shard_tree(tree, mesh)
    assert tuple(placed["word_embed"].shards[1, 1].shape) == (4, 3)
    assert tuple(placed["lstm0_b"].shards[1, 0].shape) == (12,)
    back = gather_tree(placed, mesh)
    for k, v in tree.items():
        assert torch.equal(back[k], v)
    placed["lstm0_b"].shards[0, 0].add_(1.0)
    assert torch.equal(placed["lstm0_b"].shards[1, 1], tree["lstm0_b"])


def test_vocab_shards_place_and_gather_through_the_rule_table():
    """A model's vocab shards (``VocabShards``) and the mesh optimizer's
    moments are laid out by ``shard_tree`` on the row mesh: shard j is
    ``shard_tree``'s position (0, j), gathering is bitwise, and the
    int8w scale leaves split with their tables."""
    from cst_captioning_torch.models.vocab_shards import (
        VocabShards,
        is_vocab_leaf,
    )
    from cst_captioning_torch.parallel.mesh import row_mesh

    g = torch.Generator().manual_seed(2)
    full = {"word_embed": torch.randn(8, 3, generator=g),
            "logit_w": torch.randn(3, 8, generator=g),
            "logit_b": torch.randn(8, generator=g),
            "word_embed_scale": torch.rand(8, generator=g),
            "logit_w_scale": torch.rand(8, generator=g)}
    assert all(is_vocab_leaf(k) for k in full)
    assert not any(is_vocab_leaf(k) for k in ("lstm0_w", "lstm0_w_scale",
                                               "att_wf", "cat_embed"))
    vs = VocabShards.split(full, ["cpu", "cpu"], "cpu")
    placed = shard_tree(full, row_mesh(["cpu", "cpu"]))
    for k, xs in vs.leaves.items():
        assert vs.specs[k] == placed[k].spec
        for j, x in enumerate(xs):
            assert torch.equal(x, placed[k].shards[0, j]), (k, j)
    assert tuple(vs.leaves["logit_w"][1].shape) == (3, 4)
    back = vs.gather()
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    moment = torch.randn(3, 8, generator=g)
    parts = vs.place("logit_w", moment)
    assert torch.equal(parts[1], moment[:, 4:])
    assert torch.equal(vs.gather_parts("logit_w", parts), moment)
    vs.load("logit_w", moment)
    assert torch.equal(vs.gather()["logit_w"], moment)
    with pytest.raises(ValueError, match="does not split over 3"):
        VocabShards.split(full, ["cpu"] * 3, "cpu")


# ------------------------------------------------------------ collectives

def test_embedding_rows_and_vocab_parallel_log_softmax():
    g = torch.Generator().manual_seed(1)
    table = torch.randn(12, 5, generator=g)
    ids = torch.tensor([[0, 5, 6, 11], [3, 3, 7, 2]])
    rows = embedding_rows(list(table.chunk(3, 0)), ids, torch.float32)
    assert torch.equal(rows, table[ids])
    logits = torch.randn(2, 4, 12, generator=g, requires_grad=True)
    shards = [x.detach().clone().requires_grad_(True)
              for x in logits.chunk(3, -1)]
    got = token_logprobs(VocabShardedLogits(shards, "cpu"), ids)
    want = token_logprobs(logits, ids)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    w = torch.randn(2, 4, generator=g)
    (got * w).sum().backward()
    (want * w).sum().backward()
    torch.testing.assert_close(torch.cat([s.grad for s in shards], -1),
                               logits.grad, rtol=1e-6, atol=1e-6)


def test_parallel_modules_import_no_jax():
    """``parallel/*``, ``ops/shard_decode.py`` and the sharded step
    import neither ``jax`` nor the JAX package."""
    code = (
        "import sys; import cst_captioning_torch.parallel, "
        "cst_captioning_torch.parallel.distributed, "
        "cst_captioning_torch.parallel.ring, "
        "cst_captioning_torch.ops.shard_decode, "
        "cst_captioning_torch.training.sharded, "
        "cst_captioning_torch.models.vocab_shards; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('cst_captioning_tpu')]; print(bad); "
        "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_mesh_positions_and_rows():
    mesh = make_mesh({"data": 2, "model": 2}, devices=CPU4)
    assert list(mesh.positions()) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.lead == torch.device("cpu")
    assert np.asarray(mesh.devices).shape == (2, 2)
