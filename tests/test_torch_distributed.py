"""Multi-process data parallelism of the port
(``parallel/distributed.py``, the loader's process shards, the trainer's
stop agreement) on two gloo processes on the CPU.

Tiers (docs/PARITY.md r12): one data-parallel XE step over two
processes, each on its own shard of the batch, against the
single-process (2, 1) mesh step on the whole batch — loss rtol 1e-5,
parameters rtol 2e-5 / atol 1e-5; the stop agreement stops both ranks
at the same step; the loader's shards are the JAX loader's indices.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data.build import build_dataset
from cst_captioning_torch.data.loader import BatchIterator, to_device
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.parallel import distributed, make_mesh
from cst_captioning_torch.training import sharded

REPO = __file__.rsplit("/tests/", 1)[0]
V = 40

WORKER = r"""
import sys, torch
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from cst_captioning_torch.parallel import distributed, make_mesh
from cst_captioning_torch.training import sharded
from cst_captioning_torch.training.trainer import Trainer
sys.path.insert(0, "tests")
from test_torch_distributed import _model_and_batches
distributed.ensure_initialized(f"tcp://localhost:{port}", world, rank,
                               backend="gloo")
distributed.ensure_initialized(f"tcp://localhost:{port}", world, rank)
cfg, model, batches = _model_and_batches(rank, world)
mm = sharded.MeshModel(cfg, make_mesh({"data": 1, "model": 1}, ["cpu"]),
                       model)
step = sharded.make_mesh_xe_train_step(
    mm, sharded.MeshOptimizer(mm, cfg.train, 10))
b = batches[0]
m = step(b.feats, b.feat_masks, b.captions, b.weights, None, b.video_idx,
         None, 0.0)

class Flag:
    triggered = False

class Sync:
    PREEMPTION_SYNC_EVERY = 2

flag, stopped = Flag(), None
for i in range(12):
    if rank == 1 and i == 5:
        flag.triggered = True
    if Trainer._stop_agreed(Sync(), flag, i):
        stopped = i
        break
torch.save({"params": mm.gathered_state_dict(), "loss": float(m["loss"]),
            "stopped": stopped, "shard": distributed.process_shard()}, out)
"""


def _model_and_batches(rank: int, world: int):
    """The smoke model from seed 0 and this process's batches (4 videos
    of its process shard, 3 captions each)."""
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.vocab_size = V
    cfg.model.drop_prob = 0.0
    ds, _ = build_dataset(cfg, "train")
    it = BatchIterator(ds, batch_size=4, seq_per_img=3,
                       max_frames=cfg.data.max_frames, shuffle=False,
                       shard_id=rank, num_shards=world)
    batches = [to_device(b, torch.device("cpu"))
               for b, _ in zip(it.epoch(0), range(1))]
    model = model_from_config(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return cfg, model, batches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    port = str(_free_port())
    outs = [str(d / f"rank{r}.pt") for r in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "2",
                               port, outs[r]], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(o, weights_only=False) for o in outs]


def test_two_process_step_matches_the_2x1_mesh_step(two_ranks):
    cfg, model, b0 = _model_and_batches(0, 2)
    _, _, b1 = _model_and_batches(1, 2)
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
    for r in two_ranks:
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(),
                                       rtol=2e-5, atol=1e-5, err_msg=k)
    for k in want:
        assert torch.equal(two_ranks[0]["params"][k],
                           two_ranks[1]["params"][k]), k
    assert [r["shard"] for r in two_ranks] == [(0, 2), (1, 2)]


def test_stop_agreed_stops_both_ranks_at_one_step(two_ranks):
    """Rank 1 alone raises its flag at step 5; the all-reduce runs every
    2 steps, so both ranks stop at step 6."""
    assert [r["stopped"] for r in two_ranks] == [6, 6]


def test_single_process_needs_no_init():
    assert not distributed.is_initialized()
    distributed.ensure_initialized()          # no address: a no-op
    assert not distributed.is_initialized()
    assert distributed.process_shard() == (0, 1)
    assert distributed.stop_agreed(True) and not distributed.stop_agreed(False)
    g = [torch.ones(2)]
    assert distributed.all_reduce_grads(g)[0] is g[0]


@pytest.mark.parametrize("shard,n", [(0, 1), (0, 3), (2, 3)])
def test_loader_shards_match_the_jax_loader(shard, n):
    from cst_captioning_tpu.config import get_preset as jpreset
    from cst_captioning_tpu.data import BatchIterator as JBatchIterator
    from cst_captioning_tpu.data.build import build_dataset as jbuild

    jds, _ = jbuild(jpreset("synthetic_smoke"), "train")
    tds, _ = build_dataset(tcfg.get_preset("synthetic_smoke"), "train")
    kw = dict(batch_size=4, seq_per_img=2, max_frames=6, seed=3,
              shard_id=shard, num_shards=n)
    jit, tit = JBatchIterator(jds, **kw), BatchIterator(tds, **kw)
    np.testing.assert_array_equal(tit._indices, jit._indices)
    assert tit.num_batches() == jit.num_batches()
    for jb, tb in zip(jit.epoch(1), tit.epoch(1)):
        np.testing.assert_array_equal(tb.video_idx, np.asarray(jb.video_idx))
    with pytest.raises(ValueError, match="bad shard"):
        BatchIterator(tds, 4, 2, 6, shard_id=n, num_shards=n)
