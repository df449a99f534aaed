"""Device meshes, counterpart of the 1-axis ``jax.sharding.Mesh`` that
reseek_tpu passes to its search drivers.

A mesh is an ordered tuple of ``torch.device``s along one axis, ``"db"``,
with the rank (process) that owns each position: rank 0 throughout in a
one-process run; ``parallel.multihost.global_mesh`` lays every rank's
devices out rank-major, so each rank's positions are contiguous.  Devices
may repeat: ``("cuda:0", "cuda:0")`` is two shards on one card and
``("cpu", "cpu", "cpu")`` three on the CPU.

Shards are contiguous ascending slices of the target index space
(``np.linspace`` bounds, as reseek_tpu's): the top-B merge's tie-break
relies on it (parallel/topk.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from reseek_tpu_torch.device import DeviceLike, resolve

AXIS = "db"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along the ``axis``, and the rank owning each position."""

    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...]
    axis: str = AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.ranks) != len(self.devices):
            raise ValueError("a mesh needs one rank per device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def local(self, rank: int = 0) -> Tuple[torch.device, ...]:
        """The devices of the positions that ``rank`` owns, in mesh order:
        a one-process mesh for the engine."""
        return tuple(d for d, r in zip(self.devices, self.ranks)
                     if r == rank)


MeshLike = Union[Mesh, Iterable[DeviceLike], None]


def as_mesh(mesh: MeshLike) -> Optional[Mesh]:
    """None, a ``Mesh``, or a sequence of devices (one process) -> a
    ``Mesh`` with its devices resolved (None stays None): naming ``cuda``
    without a card raises."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        return dataclasses.replace(mesh, devices=tuple(
            resolve(d) for d in mesh.devices))
    if isinstance(mesh, (str, torch.device)):
        raise TypeError("mesh: a sequence of devices, not one device")
    try:
        devs = tuple(resolve(d) for d in mesh)
    except TypeError as exc:
        raise TypeError(f"mesh: not a sequence of devices: {mesh!r}") from exc
    return Mesh(devs, (0,) * len(devs))


def shard_bounds(n: int, parts: int) -> np.ndarray:
    """[parts + 1] contiguous bounds tiling range(n)."""
    return np.linspace(0, n, parts + 1).astype(np.int64)


def host_shard_bounds(n_targets: int, process_id: int,
                      num_processes: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) target range owned by one process."""
    b = shard_bounds(n_targets, num_processes)
    return int(b[process_id]), int(b[process_id + 1])


def _mesh_shard_ranges(mesh: Mesh, n_targets: int, rank: int = 0
                       ) -> Tuple[List[Tuple[int, int, int]],
                                  List[Tuple[int, int, int]]]:
    """[(mesh position, lo, hi)]: the global target range of every mesh
    position, and the ones that ``rank`` owns (ascending position)."""
    b = shard_bounds(n_targets, mesh.size)
    allr = [(k, int(b[k]), int(b[k + 1])) for k in range(mesh.size)]
    return allr, [r for r in allr if mesh.ranks[r[0]] == rank]
