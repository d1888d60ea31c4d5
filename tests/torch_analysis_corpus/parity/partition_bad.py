# corpus-rules: partitioning
"""Twin of the reference corpus's partition_bad.py in the port's idioms
(line for line): against a toy rule table, a leaf matched by two rules
and a leaf matched by none (CST-SHD-001 at KNOWN_PARAM_LEAVES), a stale
rule (CST-SHD-003 at its line), an unregistered placement pin
(``shard_tree`` outside ``parallel/``, CST-SHD-002) and an unregistered
collective (``collectives.psum`` outside ``parallel/``, CST-SHD-004).
The negative cases — ``word_proj`` matching exactly one rule, the pin
and collective names read as plain attributes — must NOT fire.
"""

from cst_captioning_torch.parallel import collectives, sharding as placement

PARTITION_RULES = (
    (r"word_embed$", ("model", None)),
    (r"embed$", ()),
    (r"word_proj$", (None, "model")),
    (r"ghost_param$", ("model",)),  # expect: CST-SHD-003
)

KNOWN_PARAM_LEAVES = ("word_embed", "logit_w", "word_proj")  # expect: CST-SHD-001


def unregistered_constraint(x, mesh):
    return placement.shard_tree(x, mesh)  # expect: CST-SHD-002


def negative_not_a_constraint(table):
    # attribute access / unrelated names must not trip the site scan
    return table.constraints


def unregistered_shard_map(parts, device, specs):
    return collectives.psum(parts, device)  # expect: CST-SHD-004


def negative_not_a_shard_map(registry):
    # attribute reads of the name must not trip the site scan
    return registry.psum
