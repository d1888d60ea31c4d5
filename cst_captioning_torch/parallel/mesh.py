"""Device meshes from config (port of the JAX package's
``parallel/mesh.py``).

``TrainConfig.mesh_shape`` is an ordered ``{axis: size}`` dict (e.g.
``{"data": -1, "model": 1}``); a single ``-1`` absorbs the devices
left over, as the reference's DataParallel took every visible GPU.

A :class:`Mesh` is an ndarray of ``torch.device`` with named axes.  The
port has one controller: each mesh position's tensors live on that
position's device and its kernels launch there, and the collectives of
``parallel/collectives.py`` are explicit copies and sums in a fixed
shard order run by the one host thread.  Across cards those copies are
peer copies; on one card they are copies within the card.

``make_mesh(shape, devices=...)`` takes an explicit device list, in
which one device may stand at several positions: a repeated ``cpu``
device puts a (2, 2) mesh on the CPU for the tests, a repeated
``cuda:0`` puts it on one card (the counterpart of the reference tests'
forced host-device count).  With no list, :func:`local_devices` counts
the cards and never repeats one; a mesh that needs more devices than
the list holds raises with the reference's message, and nothing ever
shrinks onto fewer cards or moves to the CPU.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cst_captioning_torch.device import resolve_device

log = logging.getLogger("cst_captioning_torch.parallel")


class Mesh:
    """Named-axis ndarray of devices.  ``shape`` is the ordered
    ``{axis: size}`` dict; ``devices`` the object ndarray."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n) for a, n in
                                      zip(self.axis_names, devices.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> Iterator[Tuple[int, ...]]:
        return iter(np.ndindex(*self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The device at position (0, ..., 0): where replicated results,
        losses and the decode merge land."""
        return self.devices.flat[0]

    def model_row(self, data: int = 0) -> List[torch.device]:
        """The devices along ``model`` at data index ``data`` (a mesh
        without a ``model`` axis has a row of one)."""
        idx = [0] * self.devices.ndim
        if "data" in self.shape:
            idx[self.axis_names.index("data")] = data
        if "model" not in self.shape:
            return [self.devices[tuple(idx)]]
        out = []
        ax = self.axis_names.index("model")
        for j in range(self.shape["model"]):
            idx[ax] = j
            out.append(self.devices[tuple(idx)])
        return out

    def row(self, data: int = 0) -> "Mesh":
        """Data row ``data`` as a (1, M) mesh (``model_row``'s devices)."""
        return row_mesh(self.model_row(data))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def row_mesh(devices: Sequence) -> Mesh:
    """A (data 1 x model M) mesh over ``devices`` in the given order: one
    mesh row, as a model's vocab shards stand on it."""
    grid = np.empty((1, len(devices)), dtype=object)
    for j, d in enumerate(devices):
        grid[0, j] = torch.device(d)
    return Mesh(grid, ("data", "model"))


def local_devices() -> List[torch.device]:
    """Every card of this host, once each, in index order; a host
    without CUDA raises (``device.py::resolve_device``), never falls back
    to the CPU."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _canon(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _order_key(d: torch.device):
    return (d.type, -1 if d.index is None else d.index)


def make_mesh(shape: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh of ``shape`` over ``devices`` (default :func:`local_devices`),
    with the reference's validations and messages.  The device order is
    deterministic: sorted by (type, index), stably, so repeated devices
    keep their list order."""
    if not shape:
        raise ValueError("mesh shape is empty — need at least one axis")
    devices = [_canon(d) for d in (devices if devices is not None
                                   else local_devices())]
    devices.sort(key=_order_key)
    n = len(devices)
    sizes = dict(shape)
    bad = {k: v for k, v in sizes.items() if v != -1 and v < 1}
    if bad:
        raise ValueError(
            f"mesh axes must be positive (or -1 to absorb): {bad}")
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one -1 axis allowed, got {wild}")
    if n == 0:
        raise ValueError("no devices for the mesh")
    fixed = int(np.prod([v for v in sizes.values() if v != -1]))
    if wild:
        if n % fixed:
            fixed_axes = {k: v for k, v in sizes.items() if v != -1}
            raise ValueError(
                f"{n} devices not divisible by fixed axes {fixed_axes} "
                f"(product {fixed}) — axis {wild[0]!r} cannot absorb "
                f"{n}/{fixed} ways; pick sizes whose product divides "
                "the device count")
        sizes[wild[0]] = n // fixed
    total = int(np.prod(list(sizes.values())))
    if total > n:
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {n} — shrink an "
            "axis or add devices")
    if total < n:
        log.warning("mesh %s uses %d of %d devices — %d idle", sizes,
                    total, n, n - total)
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return Mesh(grid.reshape([sizes[k] for k in sizes]), tuple(sizes))


def mesh_from_config(cfg, devices: Optional[Sequence] = None) -> Mesh:
    return make_mesh(dict(cfg.train.mesh_shape), devices)


def submesh_groups(devices: Sequence, group_size: int) -> List[list]:
    """Deterministic per-replica device groups for (R, M) serving grids:
    sort by the same key as :func:`make_mesh`, then contiguous
    ``group_size`` slices — replica i gets devices [i·M, (i+1)·M)."""
    if group_size < 1:
        raise ValueError(f"submesh group size {group_size} < 1")
    devs = sorted((_canon(d) for d in devices), key=_order_key)
    return [devs[i:i + group_size]
            for i in range(0, len(devs) - group_size + 1, group_size)]
