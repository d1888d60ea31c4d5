"""Parallelism over a mesh of devices (port of the JAX package's
``parallel/``).

The reference's device story is ``.cuda()`` plus single-host
``nn.DataParallel``; the JAX package rebuilt it as a (data x model)
mesh under ``shard_map`` / ``NamedSharding``.  The port keeps one
controller and an explicit device list (``parallel/mesh.py``):

* ``data`` axis: the batch splits into contiguous blocks, one per data
  shard; each shard's forward and backward run on its own device and
  the gradients fold over ``data`` in shard order
  (``training/sharded.py``);
* ``model`` axis: the vocab-sized parameters (word embedding rows,
  logit-head columns, their int8w scales) split per the rule table
  (``parallel/partition.py``); embedding lookups, log-softmaxes and
  the decode's top-K merge across shards run through the fixed-order
  collectives of ``parallel/collectives.py``;
* frames: ``model.shard_frames`` splits the attention frame axis over
  ``model`` (``parallel/ring.py``);
* processes: ``parallel/distributed.py`` (``torch.distributed``, NCCL
  between cards, gloo on the CPU) with the loader's process shards.
"""

from cst_captioning_torch.parallel.collectives import (  # noqa: F401
    VocabShardedLogits,
    all_gather,
    embedding_rows,
    pmax,
    psum,
    token_logprobs,
)
from cst_captioning_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    local_devices,
    make_mesh,
    mesh_from_config,
    submesh_groups,
)
from cst_captioning_torch.parallel.partition import (  # noqa: F401
    KNOWN_PARAM_LEAVES,
    PARTITION_RULES,
    match_partition_rules,
    mesh_shape_str,
    spec_for_leaf,
    tree_specs,
)
from cst_captioning_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    sharded_context_attention,
)
from cst_captioning_torch.parallel.sharding import (  # noqa: F401
    Placed,
    gather_tree,
    shard_tree,
)
from cst_captioning_torch.parallel import distributed  # noqa: F401
