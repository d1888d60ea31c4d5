"""The sharded update step on a (data x model) mesh: XE / WXE and CST
(port of the JAX package's NamedSharding-in/out update steps,
``training/steps.py::sharded_step_kwargs`` and their callers).

:class:`MeshModel` places a model on a mesh by the rule table
(``parallel/partition.py``): one replica per data shard on that row's
first device, its vocab-sized leaves split over the row's ``model``
devices (``CaptionModel.shard_vocab``) where the vocab divides the
axis, replicated otherwise.  Every position holds its own copy.

One step (:func:`make_mesh_xe_train_step`, and CST's PG update in
:class:`MeshPlacement`):

* the batch splits over ``data`` in contiguous blocks; each data shard's
  forward and backward run on its replica, on the port's kernels (the
  ``lstm_recurrence`` / ``attlstm_recurrence`` kernels once a shard and
  layer, its vocab products on each model shard's device);
* the vocab-parallel log-softmax (``parallel/collectives.py``) gives
  the token log-probs of XE and of the PG update; each shard's loss
  divides by the WHOLE batch's mask sum, and the shards' losses add in
  shard order, so the loss is the single-device loss up to the order of
  its sums (docs/PARITY.md r12);
* the output dropout's mask is drawn once for the whole batch, as the
  single-device step draws it, and each shard takes its rows;
* gradients fold over ``data`` in shard order onto the owner copies
  (data shard 0's); across processes (``parallel/distributed.py``) they
  are then all-reduced;
* Adam (``training/steps.py::Optimizer``) updates the owner copies, with
  its moments living beside them (the vocab moments sharded like their
  parameters), and the updated values are copied to the other data
  shards' replicas.

Scheduled sampling on a mesh draws each data shard's feeds from its own
generator (seeded from the step's), so those draws differ from a single
device's; without it a mesh step reproduces the single-device step.

The CST step on a mesh is ``training/cst.py``'s own step (split or slot
rollout, reward overlap, ``phase_ms``) on a :class:`MeshPlacement`: a
rollout chunk decodes on the replica of the data shard that holds its
first video, and the PG update splits over ``data`` as the XE step does.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Tuple

import torch

from cst_captioning_torch.constants import PAD_ID
from cst_captioning_torch.models.captioner import (
    CaptionModel,
    model_from_config,
)
from cst_captioning_torch.models.vocab_shards import is_vocab_leaf
from cst_captioning_torch.parallel import distributed
from cst_captioning_torch.parallel.collectives import psum
from cst_captioning_torch.parallel.mesh import Mesh
from cst_captioning_torch.parallel.partition import (
    mesh_shape_str,
    tree_specs,
)
from cst_captioning_torch.training.cst import (
    _video_rows,
    make_cst_train_step,
    pg_loss,
)
from cst_captioning_torch.training.steps import Optimizer, xe_loss

log = logging.getLogger("cst_captioning_torch.training")


class MeshModel:
    """See module doc.  ``replicas[d]`` is data shard d's model;
    :meth:`owner_params` the tensors the optimizer updates, keyed by
    parameter name (``name#j`` for shard j of a split vocab leaf)."""

    def __init__(self, cfg, mesh: Mesh, template: CaptionModel):
        self.cfg = cfg
        self.mesh = mesh
        self.D = mesh.shape.get("data", 1)
        self.M = mesh.shape.get("model", 1)
        full = {k: v.detach() for k, v in template.full_state_dict().items()}
        self.specs = tree_specs(full, mesh)
        self.split = self.M > 1 and all(
            self.specs[n] != () for n in full if is_vocab_leaf(n))
        own = dict(template.named_parameters())
        self.names = list(own) + [n for n in full
                                  if is_vocab_leaf(n) and n not in own]
        self.replicas: List[CaptionModel] = []
        for d in range(self.D):
            if self.D == 1 and self.M == 1:
                rep = template
            else:
                rep = model_from_config(cfg, device=mesh.model_row(d)[0],
                                        mesh=mesh)
                self._load(rep, full)
                if self.split:
                    rep.shard_vocab(mesh.model_row(d))
            if self.M > 1:
                row = mesh.row(d)
                if rep.decode_mesh is not None:
                    rep.decode_mesh = row
                if rep.frame_mesh is not None:
                    rep.frame_mesh = row
                    rep.frame_batch_axis = None
            self.replicas.append(rep)
        self.lead = self.replicas[0].device

    @staticmethod
    def _load(rep: CaptionModel, full: Dict[str, torch.Tensor]) -> None:
        """Copy full tensors into a replica; a split vocab leaf through
        its shards' placement (``VocabShards.load``)."""
        with torch.no_grad():
            for k, t in full.items():
                if rep.vshards is not None and k in rep.vshards.leaves:
                    rep.vshards.load(k, t)
                else:
                    getattr(rep, k).copy_(t)

    def named_tensors(self, d: int) -> List[Tuple[str, torch.Tensor]]:
        """Replica ``d``'s trainable tensors in optimizer-key order."""
        rep = self.replicas[d]
        own = dict(rep.named_parameters())
        out = []
        for n in self.names:
            if rep.vshards is not None and n in rep.vshards.leaves:
                out += [(f"{n}#{j}", x)
                        for j, x in enumerate(rep.vshards.leaves[n])]
            else:
                out.append((n, own[n]))
        return [(k, x) for k, x in out if x.requires_grad]

    def owner_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_tensors(0))

    @torch.no_grad()
    def broadcast(self) -> None:
        """Copy the owner copies to every other data shard's replica."""
        owner = self.owner_params()
        for d in range(1, self.D):
            for k, x in self.named_tensors(d):
                x.copy_(owner[k])

    # ---------------------------------------------------- checkpoints
    def gathered_state_dict(self) -> Dict[str, torch.Tensor]:
        """A snapshot of the full state dict in CPU tensors: the port's
        one-device checkpoint format."""
        return {k: v.detach().to("cpu", copy=True) for k, v in
                self.replicas[0].full_state_dict().items()}

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Reshard a full state dict onto every replica (bitwise)."""
        from cst_captioning_torch.models.weights import params_to_state_dict

        sd = params_to_state_dict(sd)
        own = self.gathered_state_dict()
        if set(sd) != set(own):
            raise KeyError(
                f"parameter names differ: missing {sorted(set(own) - set(sd))}"
                f", unexpected {sorted(set(sd) - set(own))}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != model "
                                 f"{tuple(own[k].shape)}")
        for rep in self.replicas:
            self._load(rep, sd)

    def sharding_meta(self) -> Dict:
        """The checkpoint sidecar's mesh record (reference
        ``saved_sharding``): shape string, axes and every leaf's spec."""
        return {"mesh_shape": mesh_shape_str(self.mesh),
                "mesh_axes": list(self.mesh.axis_names),
                "specs": {k: list(v) for k, v in self.specs.items()}}


class MeshOptimizer(Optimizer):
    """:class:`~cst_captioning_torch.training.steps.Optimizer` over a
    :class:`MeshModel`'s owner copies; its state dict gathers the split
    moments to the parameters' full names (the one-device format) and
    loading splits them again."""

    def __init__(self, mm: MeshModel, cfg_train, steps_per_epoch: int):
        super().__init__(mm.owner_params(), cfg_train, steps_per_epoch)
        self.mm = mm

    def _gather(self, moments: Dict[str, torch.Tensor]):
        """Full CPU moments: a split leaf's shards gathered as its
        parameter's are (``VocabShards.gather_parts``)."""
        out: Dict[str, torch.Tensor] = {}
        parts: Dict[str, dict] = {}
        for k, v in moments.items():
            if "#" in k:
                n, j = k.split("#")
                parts.setdefault(n, {})[int(j)] = v
            else:
                out[k] = v.detach().cpu()
        vs = self.mm.replicas[0].vshards
        for n, xs in parts.items():
            out[n] = vs.gather_parts(n, [xs[j] for j in sorted(xs)])
        return out

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self._gather(self.mu),
                "nu": self._gather(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        vs = self.mm.replicas[0].vshards
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            names = {k.split("#")[0] for k in mine}
            if names != set(theirs):
                raise KeyError("optimizer state names differ from the "
                               "parameters'")
            placed = {}
            for k, dst in mine.items():
                if "#" in k:
                    n, j = k.split("#")
                    if n not in placed:
                        placed[n] = vs.place(n, theirs[n])
                    src = placed[n][int(j)]
                else:
                    src = theirs[k]
                dst.copy_(src)


def _fold_and_update(mm: MeshModel, optimizer: Optimizer,
                     loss: torch.Tensor) -> torch.Tensor:
    """Gradients of ``loss`` for every replica, folded over ``data`` in
    shard order onto the owner copies (and across processes), one
    optimizer step, then the owners copied out.  Returns the pre-clip
    global norm."""
    named = [mm.named_tensors(d) for d in range(mm.D)]
    flat = [x for nt in named for _, x in nt]
    grads = torch.autograd.grad(loss, flat)
    per: Dict[str, list] = {}
    i = 0
    for nt in named:
        for k, x in nt:
            per.setdefault(k, []).append(grads[i])
            i += 1
    owner = mm.owner_params()
    folded = {k: psum(gs, owner[k].device) for k, gs in per.items()}
    distributed.all_reduce_grads(list(folded.values()))
    gnorm = optimizer.step(folded)
    mm.broadcast()
    return gnorm


def _global_denom(mask: torch.Tensor) -> torch.Tensor:
    """The whole batch's mask sum (over processes too), clamped at 1."""
    total = mask.float().sum()
    distributed.all_reduce_grads([total])
    return torch.clamp(total, min=1.0)


def _data_blocks(mm: MeshModel, B: int):
    """``[(replica, lo, hi)]``: data shard d's contiguous block of the
    batch's B videos, on its replica."""
    if B % mm.D:
        raise ValueError(f"batch of {B} videos is not divisible by the data "
                         f"mesh axis ({mm.D})")
    n = B // mm.D
    return [(rep, d * n, (d + 1) * n) for d, rep in enumerate(mm.replicas)]


def _shard_generators(generator, D: int):
    """Scheduled sampling's per-shard generators (module doc); one data
    shard keeps the step's own."""
    if D == 1:
        return [generator]
    seeds = torch.randint(0, 2 ** 62, (D,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(int(s))
            for s in seeds]


def make_mesh_xe_train_step(mm: MeshModel, optimizer: Optimizer) -> Callable:
    """The XE / WXE step on the mesh, with the one-device step's
    signature and metrics (``training/steps.py::make_xe_train_step``)."""

    def train_step(feats, feat_masks, captions, weights, category,
                   video_idx, generator, ss_prob=0.0):
        del video_idx
        B, S, L = captions.shape
        lead = mm.lead
        caps = captions.long()
        denom = _global_denom((caps[:, :, 1:] != PAD_ID).reshape(-1))
        fused = isinstance(ss_prob, float) and ss_prob == 0.0
        keep = None
        if fused:
            rep0 = mm.replicas[0]
            keep = rep0.dropout_mask((B * S, L - 1, rep0.rnn_size),
                                     generator, lead)
        gens = [generator] * mm.D if fused else _shard_generators(generator,
                                                                 mm.D)
        losses = []
        for d, (rep, lo, hi) in enumerate(_data_blocks(mm, B)):
            dev = rep.device
            take = lambda x: _video_rows(x, lo, hi, dev)  # noqa: E731
            losses.append(xe_loss(
                rep, take(feats), take(feat_masks), take(captions),
                take(weights), gens[d], ss_prob, take(category),
                denom=denom.to(dev), dropout_keep=None if keep is None
                else keep[lo * S:hi * S]))
        loss = psum(losses, lead)
        gnorm = _fold_and_update(mm, optimizer, loss)
        loss = loss.detach()
        distributed.all_reduce_grads([loss])
        return {"loss": loss, "grad_norm": gnorm}

    return train_step


class MeshPlacement:
    """The CST step's placement on a mesh (``training/cst.py``, module
    doc "Placement"): the videos in one block a data shard, each on its
    replica, and the PG update split over ``data`` (module doc)."""

    def __init__(self, mm: MeshModel, optimizer: Optimizer):
        self.mm = mm
        self.optimizer = optimizer
        self.model = mm.replicas[0]

    def blocks(self, B: int):
        return _data_blocks(self.mm, B)

    def update(self, feats, feat_masks, S: int, tokens, mask, advantage,
               temperature: float, suppress_unk: bool, category):
        """Each data shard's PG loss over the whole batch's mask sum,
        added in shard order; gradients folded and one optimizer step.
        ``tokens`` / ``mask`` / ``advantage``: the B*S rows in the
        repeated row order, on the lead device."""
        mm = self.mm
        denom = _global_denom(mask)
        losses = []
        for rep, lo, hi in _data_blocks(mm, tokens.shape[0] // S):
            dev = rep.device
            rows = slice(lo * S, hi * S)
            losses.append(pg_loss(
                rep, _video_rows(feats, lo, hi, dev),
                _video_rows(feat_masks, lo, hi, dev), S,
                tokens[rows].to(dev), mask[rows].to(dev),
                advantage[rows].to(dev), temperature, suppress_unk,
                _video_rows(category, lo, hi, dev), denom=denom.to(dev)))
        loss = psum(losses, mm.lead)
        gnorm = _fold_and_update(mm, self.optimizer, loss)
        loss = loss.detach()
        distributed.all_reduce_grads([loss])
        return loss, gnorm


def make_mesh_cst_train_step(mm: MeshModel, optimizer: Optimizer, cfg,
                             train_ds) -> Callable:
    """The CST step on the mesh: ``training/cst.py``'s step on a
    :class:`MeshPlacement` (``train.cst_use_gt``: the mesh XE step)."""
    if cfg.train.cst_use_gt:
        log.info("cst_use_gt: dispatching CST_GT_None to the mesh WXE step")
        return make_mesh_xe_train_step(mm, optimizer)
    return make_cst_train_step(mm.replicas[0], optimizer, cfg, train_ds,
                               placement=MeshPlacement(mm, optimizer))
