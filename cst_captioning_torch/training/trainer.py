"""Trainer: the XE/WXE/CST training loop (port of the JAX package's
``training/trainer.py``, single device).

Epoch loop, per-epoch validation (greedy decode through the
``lstm_sample`` kernel -> metric suite), keep-best on val CIDEr, early
stop on patience, ``history.json``, ``best`` / ``last`` checkpoints,
warm start (``train.start_from``: XE -> WXE staging) and resume
(``train.resume``), including a mid-epoch save on SIGTERM.  All training
randomness (output dropout, scheduled sampling's draws) comes from a
generator seeded per (seed, epoch, step), so a resumed run replays the
stream an uninterrupted run would have drawn.  Scheduled sampling
follows the reference's per-epoch schedule (:func:`scheduled_sampling_prob`,
``history[epoch]["ss_prob"]``): an epoch at ``ss_prob`` 0 trains
through the fused recurrence kernels, a later one through the model's
per-step loop (``models/captioner.py``), recomputed step by step under
``train.remat``.  ``train_mode="cst"`` trains through the CST split step
(``training/cst.py``), usually warm-started from an XE/WXE checkpoint;
its per-phase step clock (``phase_ms``) lands in ``history.json`` as
epoch means ``phase_<name>_ms``, beside the epoch means of ``reward``,
``baseline`` and ``advantage``; each lap is also a span
(``training/steps.py::PhaseClock``).  ``train.trace_file`` writes the
span tracer's Chrome-trace JSON at the end of ``fit``;
``train.profile_dir`` opens a ``torch.profiler`` window (CPU and, on a
card, CUDA activities) over steps 1 .. 1 + ``profile_window_steps`` of
the first epoch and writes it there as a Chrome trace.
``train.tensorboard_dir`` writes TensorBoard scalars once an epoch
(``train/<k>`` and ``val/<metric>``, finite numbers only, step = epoch)
under ``<dir>/<cfg.name>`` through ``torch.utils.tensorboard``; without
``tensorboard`` installed it logs a warning and trains on, as the
reference does without ``tensorflow``.

Meshes (``train.mesh_shape``, ``parallel/mesh.py``): the trainer
resolves the mesh over ``devices`` (default: every card of the host,
so ``{"data": -1, "model": 1}`` trains data-parallel on all of them; an
explicit ``device`` is a one-device list).  A mesh of more than one
position trains through the sharded step of ``training/sharded.py``,
and so does a multi-process run (``parallel/distributed.py``: each
process loads its shard of every batch, ``BatchIterator(shard_id,
num_shards)``, and the gradients are all-reduced); a batch that does not
divide the ``data`` axis raises.  ``self.model`` is then data shard 0's
replica (validation decodes on it, through ``model_from_config``'s mesh
gates) and checkpoints gather to the one-device format, with the mesh
and the leaves' specs in the sidecar; any checkpoint loads onto any
mesh.  A preemption stop is agreed across processes every
:attr:`Trainer.PREEMPTION_SYNC_EVERY` steps.  The CST slot / padded
rollouts train (``train.cst_rollout``), and ``train.cst_split_layout =
"pipeline"`` warns and runs the split step.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cst_captioning_torch.config import Config
from cst_captioning_torch.data.datasets import CaptionDataset
from cst_captioning_torch.data.loader import BatchIterator, prefetch_to_device
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.device import resolve_device
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.parallel import distributed
from cst_captioning_torch.parallel.mesh import local_devices, mesh_from_config
from cst_captioning_torch.training import checkpoint as ckpt
from cst_captioning_torch.training.cst import (
    check_cst_config,
    make_cst_train_step,
)
from cst_captioning_torch.training.steps import (
    make_greedy_sample_fn,
    make_optimizer,
    make_xe_train_step,
)

log = logging.getLogger("cst_captioning_torch.trainer")


def scheduled_sampling_prob(cfg_model, epoch: int) -> float:
    """Reference ``opts.py`` schedule: zero before ``start``, then
    ``increase_prob`` more every ``increase_every`` epochs, capped."""
    if cfg_model.scheduled_sampling_start < 0:
        return 0.0
    if epoch < cfg_model.scheduled_sampling_start:
        return 0.0
    frac = ((epoch - cfg_model.scheduled_sampling_start)
            // cfg_model.scheduled_sampling_increase_every)
    return float(min(cfg_model.scheduled_sampling_increase_prob * frac,
                     cfg_model.scheduled_sampling_max_prob))


def check_trainable(cfg: Config) -> None:
    """Refuse the training configurations this slice does not run."""
    t = cfg.train
    if t.train_mode not in ("xe", "wxe", "cst"):
        raise ValueError(f"unknown train_mode {t.train_mode!r}")
    if t.train_mode == "cst" and not t.cst_use_gt:
        check_cst_config(cfg)


def _step_seed(seed: int, epoch: int, step: int) -> int:
    return ((seed * 1_000_003 + epoch) * 1_000_003 + step) % (2 ** 63)


class Trainer:
    """See module docstring.  ``device``: ``cuda`` unless the caller
    passes ``"cpu"``; ``devices``: the mesh's device list (a device may
    repeat); ``shard_id`` / ``num_shards``: this process's data shard
    (default ``distributed.process_shard()``)."""

    # Multi-process preemption agreement cadence: the all-reduce must run
    # at the same steps on every process (a conditional collective
    # deadlocks), so it fires on a fixed step modulus.
    PREEMPTION_SYNC_EVERY = 10

    def __init__(
        self,
        cfg: Config,
        train_ds: CaptionDataset,
        val_ds: Optional[CaptionDataset] = None,
        workdir: Optional[str] = None,
        device=None,
        devices=None,
        shard_id: Optional[int] = None,
        num_shards: Optional[int] = None,
    ):
        check_trainable(cfg)
        if (shard_id is None) != (num_shards is None):
            raise ValueError(
                "pass both shard_id and num_shards, or neither "
                f"(got shard_id={shard_id}, num_shards={num_shards})")
        if num_shards is None:
            shard_id, num_shards = distributed.process_shard()
        if devices is None:
            devices = ([resolve_device(device)] if device is not None
                       else local_devices())
        self.mesh = mesh_from_config(cfg, devices)
        self.device = resolve_device(self.mesh.lead)
        data_ways = self.mesh.shape.get("data", 1)
        if self.mesh.size > 1 and cfg.data.batch_size % data_ways:
            raise ValueError(
                f"data.batch_size={cfg.data.batch_size} is not divisible by "
                f"the data mesh axis ({data_ways}) — the batch shards "
                "evenly over `data`")
        self.cfg = cfg
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.vocab: Vocabulary = train_ds.vocab
        if cfg.model.vocab_size == 0:
            cfg.model.vocab_size = len(self.vocab)
        self.workdir = workdir or os.path.join(cfg.train.checkpoint_dir,
                                               cfg.name)
        os.makedirs(self.workdir, exist_ok=True)

        self.model = model_from_config(cfg, device=self.device)
        self.model.init_weights(torch.Generator().manual_seed(cfg.train.seed))
        self.train_iter = BatchIterator(
            train_ds,
            batch_size=cfg.data.batch_size,
            seq_per_img=cfg.data.seq_per_img,
            max_frames=cfg.data.max_frames,
            shuffle=cfg.data.shuffle,
            drop_last=cfg.data.drop_last,
            seed=cfg.train.seed,
            shard_id=shard_id,
            num_shards=num_shards,
        )
        steps_per_epoch = max(1, self.train_iter.num_batches())
        if cfg.train.start_from:
            log.info("warm start from %s", cfg.train.start_from)
            ckpt.restore_params(cfg.train.start_from, self.model)
        # The model checkpoints read and write: the mesh model where there
        # is one (it gathers and reshards), else the model itself.
        self._ckpt_model = self.model
        if self.mesh.size > 1 or num_shards > 1:
            from cst_captioning_torch.training import sharded

            log.info("training on a %s mesh (%d process(es))",
                     self.mesh.shape, num_shards)
            mm = sharded.MeshModel(cfg, self.mesh, self.model)
            self.mesh_model = self._ckpt_model = mm
            self.model = mm.replicas[0]
            self.optimizer = sharded.MeshOptimizer(mm, cfg.train,
                                                   steps_per_epoch)
            self._train_step = (
                sharded.make_mesh_cst_train_step(mm, self.optimizer, cfg,
                                                 train_ds)
                if cfg.train.train_mode == "cst" else
                sharded.make_mesh_xe_train_step(mm, self.optimizer))
        else:
            self.mesh_model = None
            self.optimizer = make_optimizer(
                cfg.train, steps_per_epoch,
                dict(self.model.named_parameters()))
            if cfg.train.train_mode == "cst":
                self._train_step = make_cst_train_step(
                    self.model, self.optimizer, cfg, train_ds)
            else:
                self._train_step = make_xe_train_step(self.model,
                                                      self.optimizer)
        self._sample_fn = make_greedy_sample_fn(self.model,
                                                cfg.eval.max_decode_len)
        self.history: Dict[str, dict] = {}
        self.best_score = -np.inf
        self.best_epoch = -1
        self.start_epoch = 0
        self._patience = 0
        # Mid-epoch preemption bookkeeping: how many of start_epoch's
        # steps the restored params already contain.
        self._resume_skip_steps = 0
        self._epoch_steps_done = 0
        if cfg.train.resume:
            self._try_resume()
        # Set when fit() exits through the preemption path.
        self.preempted = False
        # The train.profile_dir window: pending until it opens, then the
        # open profiler until it closes.
        self._profile_pending = bool(cfg.train.profile_dir)
        self._profiler = None
        self._tb = None
        if cfg.train.tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                # One directory per run name: the pipeline's stages each
                # restart at epoch 0.
                self._tb = SummaryWriter(
                    os.path.join(cfg.train.tensorboard_dir, cfg.name))
            except ImportError:
                log.warning(
                    "train.tensorboard_dir set but tensorboard is not "
                    "importable — TensorBoard logging disabled")

    # ------------------------------------------------------------- plumbing
    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step_generator(self, epoch: int, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_step_seed(self.cfg.train.seed, epoch, step))
        return g

    def _profile_step(self, epoch: int, nsteps: int) -> None:
        """A ``torch.profiler`` window over steps 1 .. 1 +
        ``profile_window_steps`` of the first epoch trained (reference
        ``_profile_step``); closed at the epoch's end if it is shorter."""
        if epoch != self.start_epoch:
            return
        window = max(1, int(self.cfg.train.profile_window_steps))
        if nsteps == 1 and self._profile_pending:
            self._profile_pending = False
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
            log.info("profiler window started -> %s",
                     self.cfg.train.profile_dir)
        elif nsteps == 1 + window and self._profiler is not None:
            self._close_profile()

    def _close_profile(self) -> None:
        prof, self._profiler = self._profiler, None
        self._synchronize()
        prof.stop()
        out = self.cfg.train.profile_dir
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"train-{os.getpid()}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)

    def _export_trace(self) -> None:
        """Write the span tracer's Chrome-trace JSON to
        ``train.trace_file`` (no-op with the knob unset)."""
        path = self.cfg.train.trace_file
        if not path:
            return
        from cst_captioning_torch.observability.trace import get_tracer

        with open(path, "w") as f:
            f.write(get_tracer().export_json())
        log.info("span trace written to %s (load in Perfetto)", path)

    def _try_resume(self) -> None:
        """Restore params, optimizer and counters from <workdir>/last and
        continue at the next epoch (or inside the interrupted one)."""
        last = os.path.join(self.workdir, "last")
        infos = ckpt.load_infos(last)
        if not infos:
            log.info("resume requested but no checkpoint at %s — fresh run",
                     last)
            return
        ckpt.restore_checkpoint(last, self._ckpt_model, self.optimizer)
        if "steps_done" in infos:
            self.start_epoch = int(infos["epoch"])
            self._resume_skip_steps = int(infos["steps_done"])
        else:
            self.start_epoch = int(infos["epoch"]) + 1
        bs = infos.get("best_score")
        self.best_score = -np.inf if bs is None else float(bs)
        self.best_epoch = int(infos.get("best_epoch", -1))
        self._patience = int(infos.get("patience", 0))
        hist_path = os.path.join(self.workdir, self.cfg.train.history_file)
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                self.history = json.load(f)
        log.info("resumed from %s: continuing at epoch %d (step %d, best %.4f)",
                 last, self.start_epoch, self.optimizer.count, self.best_score)

    def _last_extra(self, epoch: int, **overrides) -> Dict:
        """Resume metadata for a ``last`` checkpoint (periodic and
        preemption saves share it)."""
        extra = {
            "epoch": epoch,
            "best_score": None if self.best_score == -np.inf else self.best_score,
            "best_epoch": self.best_epoch,
            "patience": self._patience,
        }
        extra.update(overrides)
        return extra

    def _stop_agreed(self, stop_flag, step: Optional[int] = None) -> bool:
        """The global stop decision (reference ``_stop_agreed``): the
        local flag in a single process; across processes an all-reduce
        of the flags, run at fixed step boundaries (every
        ``PREEMPTION_SYNC_EVERY`` steps, or always when ``step`` is None)
        so every process stops at the same step."""
        if not distributed.is_initialized():
            return stop_flag.triggered
        if step is not None and step % self.PREEMPTION_SYNC_EVERY != 0:
            return False
        return distributed.stop_agreed(stop_flag.triggered)

    # ------------------------------------------------------------ training
    def train_epoch(self, epoch: int, stop_flag=None,
                    skip_steps: int = 0) -> Dict[str, float]:
        """One epoch.  ``skip_steps`` batches are consumed but not
        dispatched (mid-epoch resume: the restored params already hold
        those updates)."""
        cfg = self.cfg
        ss_prob = scheduled_sampling_prob(cfg.model, epoch)
        use_weights = cfg.train.train_mode != "xe"
        acc: Dict[str, List[torch.Tensor]] = {}
        # The CST step's host clock per phase (``phase_ms``), averaged
        # over the epoch into ``phase_<name>``.
        step_phases = getattr(self._train_step, "phase_ms", None)
        phase_acc: Dict[str, List[float]] = {}
        t0 = time.time()
        nsteps = 0
        self._epoch_steps_done = skip_steps
        batches = self.train_iter.epoch(epoch)
        if skip_steps:
            batches = itertools.islice(batches, skip_steps, None)
        for i, batch in enumerate(prefetch_to_device(batches, self.device),
                                  start=skip_steps):
            # Poll before dispatching: a post-signal step would fold an
            # update beyond what the checkpoint's steps_done records.
            if stop_flag is not None and self._stop_agreed(stop_flag, i):
                log.warning("preemption: stopping epoch %d before step %d",
                            epoch, i)
                break
            weights = (batch.weights if use_weights
                       else torch.ones_like(batch.weights))
            metrics = self._train_step(
                batch.feats, batch.feat_masks, batch.captions, weights,
                batch.category if self.model.use_category else None,
                batch.video_idx,
                self._step_generator(epoch, i), ss_prob)
            for k, v in metrics.items():
                acc.setdefault(k, []).append(v)
            for k, v in (step_phases or {}).items():
                phase_acc.setdefault(k, []).append(v)
            self._epoch_steps_done = i + 1
            nsteps += 1
            if cfg.train.nan_check:
                loss_now = float(metrics["loss"])
                if not np.isfinite(loss_now):
                    raise FloatingPointError(
                        f"non-finite loss {loss_now} at epoch {epoch} step "
                        f"{nsteps} (grad_norm={float(metrics['grad_norm'])})")
            if self._profile_pending or self._profiler is not None:
                self._profile_step(epoch, nsteps)
            if nsteps % cfg.train.log_every == 0:
                log.info("epoch %d step %d loss %.4f (%.2f steps/s)", epoch,
                         nsteps, float(metrics["loss"]),
                         nsteps / (time.time() - t0))
        if self._profiler is not None:  # the epoch ended first
            self._close_profile()
        # Steps are queued asynchronously: wait for the device before
        # reading the clock, so steps_per_sec counts completed steps.
        self._synchronize()
        elapsed_s = max(time.time() - t0, 1e-9)
        out = {
            f"train_{k}" if k == "loss" else k:
                float(np.mean([float(x) for x in v]))
            for k, v in acc.items()
        }
        out.setdefault("train_loss", float("nan"))
        out["ss_prob"] = ss_prob
        out["steps_per_sec"] = nsteps / elapsed_s
        for k, v in phase_acc.items():
            out[f"phase_{k}"] = float(np.mean(v))
        return out

    # ---------------------------------------------------------- evaluation
    def predict(self, ds: CaptionDataset) -> Dict[str, str]:
        """Greedy-decode every video once -> {video_id: caption}."""
        from cst_captioning_torch.evaluation import decode_dataset

        return decode_dataset(ds, self.cfg, self._sample_fn,
                              self.model.use_category, self.device,
                              vocab=self.vocab)

    def evaluate(self, ds: Optional[CaptionDataset] = None) -> Dict[str, float]:
        from cst_captioning_torch.evaluation import (
            load_cocofmt_gt,
            score_predictions,
        )

        is_val = ds is None or ds is self.val_ds
        ds = ds or self.val_ds
        if ds is None:
            raise ValueError("no validation dataset")
        # The configured GT json is the val split's.
        cocofmt = self.cfg.data.cocofmt_files.get("val", "") if is_val else ""
        return score_predictions(
            ds, self.predict(ds), self.cfg.eval.metrics,
            gts=load_cocofmt_gt(cocofmt) if cocofmt else None)

    def _tb_log(self, epoch: int, entry: Dict) -> None:
        """The epoch's finite numbers as scalars (reference ``_tb_log``):
        ``train/<k>``, and ``val/<metric>`` from the val dict."""
        if self._tb is None:
            return
        for k, v in entry.items():
            if isinstance(v, (int, float)) and np.isfinite(v):
                self._tb.add_scalar(f"train/{k}", v, epoch)
            elif isinstance(v, dict):
                for mk, mv in v.items():
                    if isinstance(mv, (int, float)) and np.isfinite(mv):
                        self._tb.add_scalar(f"val/{mk}", mv, epoch)
        self._tb.flush()

    # ----------------------------------------------------------------- fit
    def fit(self) -> Dict[str, dict]:
        from cst_captioning_torch.training.preemption import PreemptionGuard

        cfg = self.cfg
        guard = PreemptionGuard.install()
        for epoch in range(self.start_epoch, cfg.train.max_epochs):
            entry = self.train_epoch(
                epoch, stop_flag=guard,
                skip_steps=(self._resume_skip_steps
                            if epoch == self.start_epoch else 0))
            if self._stop_agreed(guard):
                # Resume replays the remainder of this epoch.
                ckpt.save_checkpoint(
                    os.path.join(self.workdir, "last"), self._ckpt_model,
                    self.optimizer,
                    self._last_extra(epoch, preempted_during=epoch,
                                     steps_done=self._epoch_steps_done))
                self.preempted = True
                log.warning("preemption checkpoint saved (%s); exiting fit",
                            os.path.join(self.workdir, "last"))
                break
            if self.val_ds is not None and (epoch + 1) % cfg.train.eval_every == 0:
                val = self.evaluate()
                entry["val"] = val
                score = val.get("CIDEr", next(
                    (v for v in val.values() if isinstance(v, float)), -np.inf))
                if score > self.best_score:
                    self.best_score = score
                    self.best_epoch = epoch
                    self._patience = 0
                    ckpt.save_checkpoint(
                        os.path.join(self.workdir, "best"), self._ckpt_model,
                        self.optimizer,
                        {"epoch": epoch, "val": val, "config": cfg.to_dict()})
                else:
                    self._patience += 1
                log.info("epoch %d val %s (best CIDEr %.4f @ %d)", epoch,
                         {k: round(v, 4) if isinstance(v, float) else v
                          for k, v in val.items()},
                         self.best_score, self.best_epoch)
            if (epoch + 1) % cfg.train.save_checkpoint_every == 0:
                ckpt.save_checkpoint(
                    os.path.join(self.workdir, "last"), self._ckpt_model,
                    self.optimizer, self._last_extra(epoch, history=entry))
            self._tb_log(epoch, entry)
            self.history[str(epoch)] = entry
            with open(os.path.join(self.workdir, cfg.train.history_file),
                      "w") as f:
                json.dump(self.history, f, indent=2)
            if (self.val_ds is not None and cfg.train.max_patience > 0
                    and self._patience >= cfg.train.max_patience):
                log.info("early stop at epoch %d", epoch)
                break
        self._export_trace()
        return self.history
