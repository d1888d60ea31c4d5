# corpus-rules: single_site
"""Torch spellings the DEC rules resolve: the topk method, the
repeat_interleave function and an expand-then-reshape fan-out."""

import numpy as np
import torch


def method_topk(scores, k):
    return scores.topk(k, dim=-1)  # expect: CST-DEC-001


def fan_out(cache, K):
    a = torch.repeat_interleave(cache, K, dim=0)  # expect: CST-DEC-004
    b = cache[:, None].expand(-1, K, -1).reshape(-1, cache.shape[-1])  # expect: CST-DEC-004
    c = np.repeat(cache, K, axis=0)  # expect: CST-DEC-004
    return a, b, c


def shared_row(cache, K, rows):
    # negative: the deduplicated layout reads row // K
    return cache[rows // K], cache.expand(2, -1)
