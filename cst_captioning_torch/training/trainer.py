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
``baseline`` and ``advantage``.

Not ported yet, refused with ``NotImplementedError`` naming their
ROADMAP.md item: the CST slot rollout and pipeline layout, multi-GPU
meshes, ``tensorboard_dir``, ``profile_dir`` and ``trace_file``.
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
from cst_captioning_torch.models.captioner import model_from_config, not_ported
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
    if any(int(v) > 1 for v in t.mesh_shape.values()):
        raise not_ported(f"train.mesh_shape={t.mesh_shape}",
                         "Queue 1, item 7 (multi-GPU)")
    for knob in ("tensorboard_dir", "profile_dir", "trace_file"):
        if getattr(t, knob):
            raise not_ported(f"train.{knob}",
                             "Queue 1, item 8 (tools and observability)")


def _step_seed(seed: int, epoch: int, step: int) -> int:
    return ((seed * 1_000_003 + epoch) * 1_000_003 + step) % (2 ** 63)


class Trainer:
    """See module docstring.  ``device``: ``cuda`` unless the caller
    passes ``"cpu"``."""

    def __init__(
        self,
        cfg: Config,
        train_ds: CaptionDataset,
        val_ds: Optional[CaptionDataset] = None,
        workdir: Optional[str] = None,
        device=None,
    ):
        check_trainable(cfg)
        self.device = resolve_device(device)
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
        )
        steps_per_epoch = max(1, self.train_iter.num_batches())
        self.optimizer = make_optimizer(cfg.train, steps_per_epoch,
                                        dict(self.model.named_parameters()))
        if cfg.train.start_from:
            log.info("warm start from %s", cfg.train.start_from)
            ckpt.restore_params(cfg.train.start_from, self.model)
        if cfg.train.train_mode == "cst":
            self._train_step = make_cst_train_step(
                self.model, self.optimizer, cfg, train_ds)
        else:
            self._train_step = make_xe_train_step(self.model, self.optimizer)
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

    # ------------------------------------------------------------- plumbing
    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step_generator(self, epoch: int, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_step_seed(self.cfg.train.seed, epoch, step))
        return g

    def _try_resume(self) -> None:
        """Restore params, optimizer and counters from <workdir>/last and
        continue at the next epoch (or inside the interrupted one)."""
        last = os.path.join(self.workdir, "last")
        infos = ckpt.load_infos(last)
        if not infos:
            log.info("resume requested but no checkpoint at %s — fresh run",
                     last)
            return
        ckpt.restore_checkpoint(last, self.model, self.optimizer)
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
            if stop_flag is not None and stop_flag.triggered:
                log.warning("preemption: stopping epoch %d before step %d",
                            epoch, i)
                break
            weights = (batch.weights if use_weights
                       else torch.ones_like(batch.weights))
            metrics = self._train_step(
                batch.feats, batch.feat_masks, batch.captions, weights,
                batch.category, batch.video_idx,
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
            if nsteps % cfg.train.log_every == 0:
                log.info("epoch %d step %d loss %.4f (%.2f steps/s)", epoch,
                         nsteps, float(metrics["loss"]),
                         nsteps / (time.time() - t0))
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
            if guard.triggered:
                # Resume replays the remainder of this epoch.
                ckpt.save_checkpoint(
                    os.path.join(self.workdir, "last"), self.model,
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
                        os.path.join(self.workdir, "best"), self.model,
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
                    os.path.join(self.workdir, "last"), self.model,
                    self.optimizer, self._last_extra(epoch, history=entry))
            self.history[str(epoch)] = entry
            with open(os.path.join(self.workdir, cfg.train.history_file),
                      "w") as f:
                json.dump(self.history, f, indent=2)
            if (self.val_ds is not None and cfg.train.max_patience > 0
                    and self._patience >= cfg.train.max_patience):
                log.info("early stop at epoch %d", epoch)
                break
        return self.history
