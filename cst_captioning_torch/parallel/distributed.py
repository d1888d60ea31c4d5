"""Multi-process bootstrap (port of the JAX package's
``parallel/distributed.py``).

The reference runs more than one process only across hosts, through
``jax.distributed``; the port's counterpart is ``torch.distributed``:
NCCL between cards, gloo on the CPU (the tests).  Inside one process the
mesh of ``parallel/mesh.py`` drives every local device from the one
controller; across processes each rank trains on its own shard of every
global batch (``BatchIterator(shard_id=rank, num_shards=world)``) and
:func:`all_reduce_grads` sums the gradients.

Nothing on a machine tells a program of its cluster: pass the address
(``tcp://localhost:<port>``), the world size and the rank, as arguments
or as ``CST_INIT_METHOD``, ``CST_WORLD_SIZE`` and ``CST_RANK``.  A run
with no address configured is a single process and initialises nothing.

Usage (one command per rank)::

    from cst_captioning_torch.parallel import distributed
    distributed.ensure_initialized("tcp://localhost:29500", world, rank)
    trainer = Trainer(cfg, train_ds, val_ds)   # shards data per process
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import torch

log = logging.getLogger("cst_captioning_torch.parallel")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def ensure_initialized(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       backend: Optional[str] = None) -> None:
    """Idempotent ``init_process_group``: a second call does nothing,
    and so does a call with no address (a single process).  The backend
    defaults to NCCL where CUDA is available, gloo otherwise."""
    import torch.distributed as dist

    if is_initialized():
        return
    init_method = init_method or os.environ.get("CST_INIT_METHOD")
    if init_method is None:
        log.debug("single-process run; skipping init_process_group")
        return
    world_size = world_size if world_size is not None else _env_int(
        "CST_WORLD_SIZE")
    # `or` would drop an explicit rank 0.
    rank = rank if rank is not None else _env_int("CST_RANK")
    if world_size is None or rank is None:
        raise ValueError("a multi-process run needs its world size and "
                         "rank (arguments or CST_WORLD_SIZE / CST_RANK)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    log.info("torch.distributed initialized (%s): process %d/%d", backend,
             dist.get_rank(), dist.get_world_size())


def process_shard() -> tuple:
    """(shard_id, num_shards) for host-sharded data loading."""
    if not is_initialized():
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each gradient over the processes (in place; a single process
    returns them as they are).  The NCCL / gloo ring sums in its own
    fixed order, the same on every run of one world size."""
    if not is_initialized():
        return list(grads)
    import torch.distributed as dist

    for g in grads:
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
    return list(grads)


def stop_agreed(local_stop: bool) -> bool:
    """True on every process when any process asks to stop (an
    all-reduce MAX of the flag), so all ranks leave the epoch at the
    same step and none waits forever in the next collective."""
    if not is_initialized():
        return bool(local_stop)
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([1 if local_stop else 0], dtype=torch.int32,
                        device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())
