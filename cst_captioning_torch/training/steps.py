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
  ``lr * decay^(n // (every * steps_per_epoch))``;
* every leaf updates in its own dtype (``model.param_dtype``): on
  bfloat16 / float16 leaves the moments, the norm, the clip, the
  learning rate and every product round into that dtype as optax 0.2.6
  rounds them (:class:`Optimizer`), bitwise the reference's jitted chain
  on bf16 leaves; on float32 leaves those roundings are no-ops.

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

    Every lap is also a span (``observability/trace.py``): ``lap(key)``
    records its interval as ``phase/<key less _ms>`` and ``commit`` the
    step as ``cst/step``, their root, in the Chrome-trace format of the
    serving ``/debug/trace`` export (``train.trace_file`` writes the
    export at the end of ``fit``)."""

    def __init__(self, tags: Optional[Dict[str, str]] = None, tracer=None):
        if tracer is None:
            from cst_captioning_torch.observability.trace import get_tracer

            tracer = get_tracer()
        self.tracer = tracer
        self.tags = dict(tags or ())
        self._t0 = self._last = None
        self._acc: Dict[str, float] = {}
        self._trace_id: Optional[str] = None
        self._root_id: Optional[str] = None

    def start(self) -> None:
        self._t0 = self._last = time.monotonic()
        self._acc = {}
        if self.tracer.enabled:
            self._trace_id = self.tracer.new_trace_id()
            self._root_id = self.tracer.new_span_id()

    def lap(self, key: str) -> None:
        now = time.monotonic()
        self._acc[key] = self._acc.get(key, 0.0) + (now - self._last) * 1e3
        if self.tracer.enabled:
            name = key[:-3] if key.endswith("_ms") else key
            self.tracer.record(f"phase/{name}", self._last, now,
                               trace_id=self._trace_id,
                               parent_id=self._root_id,
                               tags=self.tags or None)
        self._last = now

    def commit(self, into: Dict[str, float]) -> Dict[str, float]:
        now = time.monotonic()
        total = (now - self._t0) * 1e3
        if self.tracer.enabled:
            self.tracer.record("cst/step", self._t0, now,
                               trace_id=self._trace_id, span_id=self._root_id,
                               tags=self.tags or None)
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


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm`` of the named ``tensors``, in their own
    dtype, on the first tensor's device (the tensors of a mesh step live
    on several): each leaf's squares in its dtype, summed with float32
    accumulation and rounded once into the leaf's dtype (as XLA's reduce
    of a bf16 / f16 leaf returns it; a no-op for float32), the leaf sums
    added in the
    tree's order (sorted names, ``jax.tree.leaves``' order of a dict),
    then the square root.  A vocab leaf split over a mesh row arrives
    as its shards ``name#j``: their partial sums add in float32 before
    the one rounding, so the split leaf counts as the whole one does."""
    dev = next(iter(tensors.values())).device
    sums: Dict[str, torch.Tensor] = {}
    dtypes: Dict[str, torch.dtype] = {}
    for k in sorted(tensors):
        leaf = k.split("#")[0]
        t = tensors[k]
        s = (t * t).sum(dtype=torch.float32).to(dev)
        sums[leaf] = s if leaf not in sums else sums[leaf] + s
        dtypes[leaf] = tensors[k].dtype
    total = None
    for leaf in sorted(sums):
        s = sums[leaf].to(dtypes[leaf])
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_leaf(g: torch.Tensor, gnorm: torch.Tensor,
              max_norm: float) -> torch.Tensor:
    """One leaf of ``optax.clip_by_global_norm``: ``g`` where ``gnorm <
    max_norm``, else ``(g / gnorm) * max_norm`` in ``g``'s dtype, the
    norm cast to it (``g_norm.astype(t.dtype)``) and ``max_norm``
    rounded to it (a weak-typed scalar); the comparison in the norm's
    dtype."""
    keep = gnorm < torch.tensor(max_norm, dtype=gnorm.dtype)
    return torch.where(keep.to(g.device), g,
                       (g / gnorm.to(g.device, g.dtype))
                       * torch.tensor(max_norm, dtype=g.dtype))


class Optimizer:
    """optax-equivalent chain over a dict of named parameters; see the
    module docstring.  ``step(grads)`` applies one update in place and
    returns the pre-clip global gradient norm.

    Every leaf updates in its own dtype, as optax 0.2.6 runs the chain
    on it: the moments live in the leaf dtype; each Python constant of
    the chain (``1 - b1``, ``b1``, ``eps``, the weight decay, the clip's
    ``max_norm``) is rounded to that dtype before its product (JAX's
    weak types), as are the scheduled learning rate and the global norm
    (``scale_by_schedule``'s ``jnp.array(step_size, dtype=g.dtype)``,
    ``clip_by_global_norm``'s ``g_norm.astype(t.dtype)``); every
    operation rounds into the dtype (a bf16 product rounds once, which
    ``p.add_(lr * u)`` also does: ``lr * u`` then ``p + u``).  The bias
    corrections ``1 - b^n`` are float32, rounded to the leaf dtype before
    the division.  On float32 leaves every rounding is a no-op."""

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
        gnorm = global_norm(grads)
        updates = dict(grads)
        if self.grad_clip > 0:
            updates = {k: clip_leaf(g, gnorm, self.grad_clip)
                       for k, g in updates.items()}
        # The scheduled rate in float32, as the reference's schedule
        # returns it, then rounded to each update's dtype like the
        # chain's other scalars (scale_by_schedule's
        # jnp.array(step_size, dtype=g.dtype)): lr * u rounds once,
        # p.add_ once more (apply_updates).
        lr32 = float(torch.tensor(-self.schedule(self.count),
                                  dtype=torch.float32))
        n = self.count + 1
        for k, p in self.params.items():
            g = updates[k]
            if self.kind == "adam":
                mu, nu = self.mu[k], self.nu[k]
                u = adam_direction(g, mu, nu, n, self.b1, self.b2, self.eps)
                if self.weight_decay > 0:
                    u = u + _const(self.weight_decay, p) * p
            elif self.kind == "rmsprop":
                nu = self.nu[k]
                u = rmsprop_direction(g, nu)
            else:
                u = g
            lr = _const(lr32, u)
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


def adam_direction(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                   n: int, b1: float, b2: float, eps: float) -> torch.Tensor:
    """``optax.scale_by_adam`` on one leaf: the moments ``mu`` / ``nu``
    updated in place in their dtype, then the bias-corrected direction
    ``mu_hat / (sqrt(nu_hat) + eps)`` in ``g``'s dtype (update ``n``,
    counted from 1)."""
    mu.copy_(_const(1 - b1, g) * g + _const(b1, g) * mu)
    nu.copy_(_const(1 - b2, g) * (g * g) + _const(b2, g) * nu)
    mu_hat = mu / (1 - torch.tensor(b1) ** n).to(mu.dtype)
    nu_hat = nu / (1 - torch.tensor(b2) ** n).to(nu.dtype)
    return mu_hat / (torch.sqrt(nu_hat) + _const(eps, g))


def rmsprop_direction(g: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
    """``optax.scale_by_rms`` on one leaf (decay 0.9, ``eps`` inside the
    square root): ``nu`` updated in place, then ``rsqrt(nu + eps) * g``."""
    nu.copy_(_const(1 - RMSPROP_DECAY, g) * (g * g)
             + _const(RMSPROP_DECAY, g) * nu)
    return torch.rsqrt(nu + _const(RMSPROP_EPS, g)) * g


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """The chain's Python constant ``x`` as a 0-dim tensor in ``like``'s
    dtype: rounded to it first, as JAX rounds a weak-typed scalar."""
    return torch.tensor(x, dtype=like.dtype)


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
            ss_prob: float = 0.0, category=None, denom=None,
            dropout_keep=None) -> torch.Tensor:
    """The masked (W)XE loss of one batch (reference ``loss_fn``);
    ``denom`` / ``dropout_keep``: a mesh step's whole-batch normaliser
    and this shard's rows of the whole batch's dropout mask."""
    caps, w, S = _flatten_batch(captions.long(), weights)
    inputs, targets = caps[:, :-1], caps[:, 1:]
    tmask = (targets != PAD_ID).float()
    logits = model(feats, feat_masks, inputs, category=category,
                   ss_prob=ss_prob, generator=generator, repeat=S,
                   dropout_keep=dropout_keep)
    return weighted_cross_entropy(logits, targets, tmask, w, denom)


def make_xe_train_step(model: CaptionModel, optimizer: Optimizer) -> Callable:
    """XE/WXE train step.  WXE is XE with non-uniform ``weights`` (the
    loader supplies consensus weights; ones for plain XE).

    Signature (the reference's, with the state held by ``model`` and
    ``optimizer``): ``(feats, feat_masks, captions (B,S,L), weights
    (B,S), category (B,)|None, video_idx (B,), generator, ss_prob) ->
    {"loss", "grad_norm"}`` as device scalars; ``grad_norm`` is the
    pre-clip global norm.  ``category`` reaches the model (None without
    ``use_category``); ``video_idx`` is unused here (the CST step needs
    it)."""
    names = [k for k, p in model.named_parameters()]
    params = [p for k, p in model.named_parameters()]

    def train_step(feats, feat_masks, captions, weights, category,
                   video_idx, generator, ss_prob=0.0):
        loss = xe_loss(model, feats, feat_masks, captions, weights,
                       generator, ss_prob, category)
        grads = torch.autograd.grad(loss, params)
        gnorm = optimizer.step(dict(zip(names, grads)))
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_greedy_sample_fn(model: CaptionModel, max_len: int) -> Callable:
    """Greedy decode for validation through the ``lstm_sample`` kernel
    (reference per-epoch val pass)."""

    def sample(feats, feat_masks, category):
        return model.sample(feats, feat_masks, category, max_len=max_len,
                            greedy=True).tokens

    return sample
