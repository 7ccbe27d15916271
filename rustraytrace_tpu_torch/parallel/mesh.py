"""The ('px', 'spp') mesh over ``torch.distributed`` (counterpart:
``rustraytrace_tpu/parallel/mesh.py``).

A JAX mesh is a grid of devices in one program; here it is a grid of
ranks, one process each.  Rank r sits at ``(r // spp, r % spp)``, as the
JAX package reshapes its device list to ``(px, spp)``.  Without an
initialized process group the mesh is the 1x1 mesh of this process (one
card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist


def mesh_axis_sizes(n_devices: int,
                    spp_shards: Optional[int] = None) -> Tuple[int, int]:
    """Factor ``n_devices`` into (px_shards, spp_shards): everything on
    the pixel axis unless an spp split is asked for (mesh.py:11-24 there).
    """
    if spp_shards is None:
        return n_devices, 1
    if n_devices % spp_shards != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by spp_shards={spp_shards}")
    return n_devices // spp_shards, spp_shards


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('px', 'spp') grid of ranks: its sizes, this rank's coordinates,
    and the process group (None for the mesh of one process)."""

    px: int
    spp: int
    px_idx: int = 0
    spp_idx: int = 0
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"px": self.px, "spp": self.spp}

    @property
    def size(self) -> int:
        return self.px * self.spp

    @property
    def rank(self) -> int:
        """This rank's index in the group, px-major (0 for one process)."""
        return self.px_idx * self.spp + self.spp_idx


def make_mesh(spp_shards: Optional[int] = None, group=None) -> Mesh:
    """The mesh over ``group`` (default: the world group when one is
    initialized, else this process alone)."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a group was given, but no process group is "
                             "initialized")
        n_px, n_spp = mesh_axis_sizes(1, spp_shards)
        return Mesh(n_px, n_spp)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_px, n_spp = mesh_axis_sizes(n, spp_shards)
    return Mesh(n_px, n_spp, rank // n_spp, rank % n_spp,
                group if group is not None else dist.group.WORLD)
