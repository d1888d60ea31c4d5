"""Training criteria (port of the JAX package's ``ops/losses.py``).

* ``masked_cross_entropy`` — token-level XE over the padded caption
  matrix, averaged over real tokens (optional label smoothing);
* ``weighted_cross_entropy`` — WXE: each caption's tokens scaled by its
  consensus weight, normalised by the *unweighted* mask sum;
* ``reward_criterion`` — REINFORCE ``-advantage * logprob * mask``
  normalised by the mask sum (the CST slice's loss).

All reductions are float32 whatever the activation dtype.
"""

from __future__ import annotations

import torch


def _token_logprobs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log p(target_t) per token.  logits (B, T, V); targets (B, T) int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _normaliser(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask.sum(), min=1.0)


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, *,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean negative log-likelihood over unmasked tokens."""
    mask = mask.float()
    nll = -_token_logprobs(logits, targets)
    if label_smoothing > 0.0:
        logp = torch.log_softmax(logits.float(), dim=-1)
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return (nll * mask).sum() / _normaliser(mask)


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor,
                           caption_weights: torch.Tensor) -> torch.Tensor:
    """WXE: ``caption_weights`` (B,) scales every token of its caption;
    the normaliser stays the unweighted mask sum."""
    mask = mask.float()
    nll = -_token_logprobs(logits, targets)
    w = caption_weights.float()[:, None]
    return (nll * mask * w).sum() / _normaliser(mask)


def reward_criterion(logprobs: torch.Tensor, mask: torch.Tensor,
                     advantage: torch.Tensor) -> torch.Tensor:
    """Policy-gradient loss ``-E[advantage * log p(sampled token)]``;
    ``advantage`` (B,) is a constant (no gradient flows through it)."""
    mask = mask.float()
    adv = advantage.detach().float()[:, None]
    loss = -logprobs.float() * adv * mask
    return loss.sum() / _normaliser(mask)
