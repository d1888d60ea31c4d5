"""Train-step factories, the LR schedule, the optimizer and the CST
step's phase clock (port of the JAX package's ``training/steps.py``).

The optimizer keeps optax's semantics, not torch's defaults, so a port
run follows the reference's trajectory:

* ``clip_by_global_norm`` runs first and scales by ``(g / norm) *
  max_norm`` only when ``norm >= max_norm`` (no ``+1e-6`` as in
  ``torch.nn.utils.clip_grad_norm_``);
* ``adam`` / ``adamw``: bias-corrected moments, ``eps`` outside the
  square root, decoupled weight decay added to the Adam direction
  before the learning rate;
* ``rmsprop``: decay 0.9 with ``eps`` inside the square root (torch's
  ``RMSprop`` uses alpha 0.99 with ``eps`` outside);
* ``sgd``: plain ``-lr * g``;
* the learning rate of update ``n`` (counted from 0) is
  ``lr * decay^(n // (every * steps_per_epoch))``.

Parameters update in place, so each update bumps their version counter
(the decode kernels' weight cache keys on it).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from cst_captioning_torch.constants import PAD_ID
from cst_captioning_torch.models.captioner import CaptionModel
from cst_captioning_torch.ops.losses import weighted_cross_entropy

OPTIMIZERS = ("adam", "sgd", "rmsprop")
RMSPROP_DECAY = 0.9
RMSPROP_EPS = 1e-8


class PhaseClock:
    """Per-step wall-time breakdown of a host-driven train step (the CST
    split step, ``training/cst.py``), on ``time.monotonic()``::

        clock.start()
        ... ; clock.lap("sample_fetch_ms")
        ... ; clock.lap("score_ms")
        clock.commit(into)   # rounds, writes the phase dict, adds total_ms

    ``lap(key)`` accumulates into ``key`` (laps inside loops add up), so
    one step's phases sum to ``total_ms`` less the unlapped gaps.  The
    dict ``commit`` writes holds plain host floats; the trainer averages
    them into the epoch's history entry as ``phase_<key>``.

    The reference also records each lap as a span of its tracer
    (``observability/``); the tracer is not ported (ROADMAP.md Queue 1,
    item 8), so this clock has no span hook."""

    def __init__(self):
        self._t0 = self._last = None
        self._acc: Dict[str, float] = {}

    def start(self) -> None:
        self._t0 = self._last = time.monotonic()
        self._acc = {}

    def lap(self, key: str) -> None:
        now = time.monotonic()
        self._acc[key] = self._acc.get(key, 0.0) + (now - self._last) * 1e3
        self._last = now

    def commit(self, into: Dict[str, float]) -> Dict[str, float]:
        total = (time.monotonic() - self._t0) * 1e3
        into.clear()
        into.update({k: round(v, 3) for k, v in self._acc.items()})
        into["total_ms"] = round(total, 3)
        return into


def make_lr_schedule(cfg_train, steps_per_epoch: int) -> Callable[[int], float]:
    """lr * decay^(epoch // decay_every), epoch = step // steps_per_epoch."""
    base, decay, every = (cfg_train.learning_rate, cfg_train.lr_decay,
                          cfg_train.lr_decay_every)
    if every <= 0 or decay >= 1.0 - 1e-9:
        return lambda step: base
    decay_steps = max(1, every * steps_per_epoch)
    return lambda step: base * decay ** (int(step) // decay_steps)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (float32)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class Optimizer:
    """optax-equivalent chain over a dict of named parameters; see the
    module docstring.  ``step(grads)`` applies one update in place and
    returns the pre-clip global gradient norm."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg_train,
                 steps_per_epoch: int):
        if cfg_train.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg_train.optimizer!r}")
        self.params = dict(params)
        self.kind = cfg_train.optimizer
        self.grad_clip = float(cfg_train.grad_clip)
        self.b1, self.b2 = float(cfg_train.beta1), float(cfg_train.beta2)
        self.eps = float(cfg_train.epsilon)
        self.weight_decay = float(cfg_train.weight_decay)
        self.schedule = make_lr_schedule(cfg_train, steps_per_epoch)
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        if self.kind in ("adam", "rmsprop"):
            self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        if self.kind == "adam":
            self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        gnorm = global_norm(grads.values())
        updates = dict(grads)
        if self.grad_clip > 0:
            keep = gnorm < self.grad_clip
            updates = {k: torch.where(keep, g, (g / gnorm) * self.grad_clip)
                       for k, g in updates.items()}
        lr = torch.tensor(-self.schedule(self.count), dtype=torch.float32)
        n = self.count + 1
        for k, p in self.params.items():
            g = updates[k]
            if self.kind == "adam":
                mu, nu = self.mu[k], self.nu[k]
                mu.copy_((1 - self.b1) * g + self.b1 * mu)
                nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
                mu_hat = mu / (1 - torch.tensor(self.b1) ** n)
                nu_hat = nu / (1 - torch.tensor(self.b2) ** n)
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
                if self.weight_decay > 0:
                    u = u + self.weight_decay * p
            elif self.kind == "rmsprop":
                nu = self.nu[k]
                nu.copy_((1 - RMSPROP_DECAY) * (g * g) + RMSPROP_DECAY * nu)
                u = g * torch.rsqrt(nu + RMSPROP_EPS)
            else:
                u = g
            p.add_(lr.to(p.device) * u)
        self.count = n
        return gnorm

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if set(mine) != set(theirs):
                raise KeyError("optimizer state names differ from the "
                               "parameters'")
            for k, v in theirs.items():
                mine[k].copy_(v)


def make_optimizer(cfg_train, steps_per_epoch: int,
                   params: Dict[str, torch.Tensor]) -> Optimizer:
    return Optimizer(params, cfg_train, steps_per_epoch)


def _flatten_batch(captions, weights):
    """(B, S, L) captions -> caption-major (B*S, L) + flat weights.
    Features are not tiled here: the model's ``repeat=S`` tiles the
    projected cache after the feature projections."""
    B, S, L = captions.shape
    return captions.reshape(B * S, L), weights.reshape(B * S), S


def xe_loss(model: CaptionModel, feats, feat_masks, captions, weights,
            generator: Optional[torch.Generator] = None,
            ss_prob: float = 0.0) -> torch.Tensor:
    """The masked (W)XE loss of one batch (reference ``loss_fn``)."""
    caps, w, S = _flatten_batch(captions.long(), weights)
    inputs, targets = caps[:, :-1], caps[:, 1:]
    tmask = (targets != PAD_ID).float()
    logits = model(feats, feat_masks, inputs, ss_prob=ss_prob,
                   generator=generator, repeat=S)
    return weighted_cross_entropy(logits, targets, tmask, w)


def make_xe_train_step(model: CaptionModel, optimizer: Optimizer) -> Callable:
    """XE/WXE train step.  WXE is XE with non-uniform ``weights`` (the
    loader supplies consensus weights; ones for plain XE).

    Signature (the reference's, with the state held by ``model`` and
    ``optimizer``): ``(feats, feat_masks, captions (B,S,L), weights
    (B,S), category (B,)|None, video_idx (B,), generator, ss_prob) ->
    {"loss", "grad_norm"}`` as device scalars; ``grad_norm`` is the
    pre-clip global norm.  ``category`` and ``video_idx`` are unused
    here (the CST step needs them)."""
    names = [k for k, p in model.named_parameters()]
    params = [p for k, p in model.named_parameters()]

    def train_step(feats, feat_masks, captions, weights, category,
                   video_idx, generator, ss_prob=0.0):
        loss = xe_loss(model, feats, feat_masks, captions, weights,
                       generator, ss_prob)
        grads = torch.autograd.grad(loss, params)
        gnorm = optimizer.step(dict(zip(names, grads)))
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_greedy_sample_fn(model: CaptionModel, max_len: int) -> Callable:
    """Greedy decode for validation through the ``lstm_sample`` kernel
    (reference per-epoch val pass)."""

    def sample(feats, feat_masks, category):
        return model.sample(feats, feat_masks, max_len=max_len,
                            greedy=True).tokens

    return sample
