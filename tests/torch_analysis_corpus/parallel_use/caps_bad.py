# corpus-rules: partitioning
"""The decode-kernel capability table in the port's shape: a stale row
and an undeclared flag (both at the table), and the port's gate
function (``_mesh_gates``) deciding on a hardcoded mesh condition.  A
gate that consults ``kernel_supports`` stays quiet."""

from dataclasses import dataclass

DECODE_KERNEL_CAPS = {  # expect: CST-SHD-005
    "use_pallas_sampler": {"model": True, "data": False},
    "use_pallas_ghost": {"model": False, "data": False},
}


def kernel_supports(flag, axis):
    caps = DECODE_KERNEL_CAPS.get(flag)
    return bool(caps and caps.get(axis, False))


@dataclass
class ModelConfig:
    use_pallas_sampler: bool = False
    use_pallas_beam: bool = False       # no caps row: fires at the table


def _mesh_gates(model, cfg, mesh):  # expect: CST-SHD-005
    if mesh.shape.get("model", 1) > 1:
        model.decode_mesh = None


def gates_through_table(model, mesh):
    # negative: not a gate by name, and it consults the table anyway
    return kernel_supports("use_pallas_sampler", "model")
