# corpus-rules: partitioning
"""Collectives and placement pins outside parallel/ with no registry
entry: torch.distributed collectives, the ring's attention, a
shard_leaf pin.  Non-collective torch.distributed calls stay quiet."""

import torch.distributed as dist

from cst_captioning_torch.parallel.ring import ring_attention
from cst_captioning_torch.parallel.sharding import shard_leaf


def sync_grads(grads):
    for g in grads:
        dist.all_reduce(g)  # expect: CST-SHD-004
    return dist.get_rank()


def frames(q, k, v, mesh):
    return ring_attention(q, k, v, mesh)  # expect: CST-SHD-004


def pin(t, spec, mesh):
    return shard_leaf(t, spec, mesh)  # expect: CST-SHD-002
