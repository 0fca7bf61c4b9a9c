"""Device meshes (port of ``srs_tpu/parallel/mesh.py``).

A mesh is an array of ``torch.device``s with named axes: ``data`` (the tile
batch), ``space`` (canvas rows, with halo exchange) and any other the
caller names. One process drives every device of a mesh, as the
reference's single controller drives its ``jax.sharding.Mesh``. Devices
may repeat: a *virtual mesh* (``[torch.device("cpu")] * 8``, or one card
four times) runs the sharded code paths on one device, the port's
counterpart of the reference's ``--xla_force_host_platform_device_count``.

``data_sharding``, ``spatial_sharding`` and ``replicated`` are placement
descriptors: a mesh and one axis name (or None) per tensor dimension, with
``split`` (the per-device shards) and ``gather`` (the tensor back).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["Mesh", "Sharding", "make_mesh", "data_sharding", "spatial_sharding", "replicated"]


class Mesh:
    """Named axes over an object array of ``torch.device``s."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at coordinate 0 of every other axis
        (one device when the mesh has no such axis)."""
        if axis not in self.axis_names:
            return [self.devices.reshape(-1)[0]]
        index = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[index])

    def distinct_devices(self) -> int:
        return len({str(d) for d in self.devices.reshape(-1)})


def make_mesh(
    shape: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Build a mesh from an axis-name -> size dict.

    With ``shape=None`` all devices go on a 1-D ``data`` axis. One size of
    -1 is inferred. ``devices`` defaults to every CUDA device torch sees
    (which raises without a card); a mesh that needs more devices than it
    is given raises ``ValueError``, as in the reference.
    """
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if not shape:
        shape = {"data": n}
    names = list(shape.keys())
    sizes = [int(s) for s in shape.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one inferred (-1) axis")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, have {n}")
    arr = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        arr[i] = d
    return Mesh(arr.reshape(sizes), tuple(names))


@dataclass(frozen=True)
class Sharding:
    """Tensor dimension ``j`` split over mesh axis ``spec[j]`` (None:
    whole); dimensions past the spec and axes it does not name are
    replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def _coords(self):
        return itertools.product(*(range(n) for n in self.mesh.devices.shape))

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The shard of each mesh device (row-major device order), on it.
        Split dimensions must divide evenly, as XLA requires."""
        out = []
        for coord in self._coords():
            part = x
            for dim, axis in enumerate(self.spec):
                if axis is None:
                    continue
                n = self.mesh.shape[axis]
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not divide "
                                     f"over {axis}={n}")
                size = x.shape[dim] // n
                part = part.narrow(dim, coord[self.mesh.axis_names.index(axis)] * size, size)
            out.append(part.to(self.mesh.devices[coord]))
        return out

    def gather(self, shards: Sequence[torch.Tensor],
               device: Optional[torch.device] = None) -> torch.Tensor:
        """The tensor ``split`` cut into ``shards``, on ``device`` (the first
        shard's by default)."""
        device = device or shards[0].device
        by_coord = dict(zip(self._coords(), shards))
        names = self.mesh.axis_names

        def assemble(dim: int, fixed: Dict[str, int]) -> torch.Tensor:
            if dim == len(self.spec):
                coord = tuple(fixed.get(a, 0) for a in names)
                return by_coord[coord].to(device)
            axis = self.spec[dim]
            if axis is None:
                return assemble(dim + 1, fixed)
            parts = [assemble(dim + 1, {**fixed, axis: i}) for i in range(self.mesh.shape[axis])]
            return torch.cat(parts, dim=dim)

        return assemble(0, {})


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch/tile) dimension."""
    return Sharding(mesh, (axis,))


def spatial_sharding(mesh: Mesh, data_axis: str = "data", space_axis: str = "space") -> Sharding:
    """[N, H, W, C]: batch over ``data_axis``, rows over ``space_axis``."""
    return Sharding(mesh, (data_axis, space_axis, None, None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
