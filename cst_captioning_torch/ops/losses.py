"""Training criteria (port of the JAX package's ``ops/losses.py``).

* ``masked_cross_entropy`` — token-level XE over the padded caption
  matrix, averaged over real tokens (optional label smoothing);
* ``weighted_cross_entropy`` — WXE: each caption's tokens scaled by its
  consensus weight, normalised by the *unweighted* mask sum;
* ``reward_criterion`` — REINFORCE ``-advantage * logprob * mask``
  normalised by the mask sum (the CST slice's loss).

All reductions are float32 whatever the activation dtype.  The logits
may be ``parallel/collectives.py::VocabShardedLogits`` (a vocab split
over a mesh's ``model`` axis): the token log-probs then come from the
vocab-parallel log-softmax.  ``denom`` replaces the batch's own
normaliser: the mesh step splits a batch over data shards and divides
every shard's sum by the whole batch's mask sum.
"""

from __future__ import annotations

import torch

from cst_captioning_torch.parallel.collectives import token_logprobs


def _token_logprobs(logits, targets: torch.Tensor) -> torch.Tensor:
    """log p(target_t) per token.  logits (B, T, V); targets (B, T) int."""
    return token_logprobs(logits, targets)


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


def weighted_cross_entropy(logits, targets: torch.Tensor,
                           mask: torch.Tensor,
                           caption_weights: torch.Tensor,
                           denom=None) -> torch.Tensor:
    """WXE: ``caption_weights`` (B,) scales every token of its caption;
    the normaliser stays the unweighted mask sum (or ``denom``)."""
    mask = mask.float()
    nll = -_token_logprobs(logits, targets)
    w = caption_weights.float()[:, None]
    return (nll * mask * w).sum() / (_normaliser(mask) if denom is None
                                     else denom)


def reward_criterion(logprobs: torch.Tensor, mask: torch.Tensor,
                     advantage: torch.Tensor, denom=None) -> torch.Tensor:
    """Policy-gradient loss ``-E[advantage * log p(sampled token)]``;
    ``advantage`` (B,) is a constant (no gradient flows through it)."""
    mask = mask.float()
    adv = advantage.detach().float()[:, None]
    loss = -logprobs.float() * adv * mask
    return loss.sum() / (_normaliser(mask) if denom is None else denom)
