"""Device meshes over torch.distributed ranks, the port of the JAX
package's `parallel/mesh.py`.

Axes, as in the JAX package:
  dp — data/request parallelism (continuous batching across replicas)
  tp — tensor parallelism (attention heads / MLP)

A `DeviceMesh` of shape (dp, tp) over the world's ranks 0 .. dp*tp - 1;
`mesh.get_group("tp")` is the group a rank's tensor-parallel collectives
run over. Where the JAX package places a global array with a sharding
annotation, each rank here holds its own slice (`shard`) or a copy that
the axis' first rank broadcasts (`replicate`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(tp: Optional[int] = None, dp: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """(dp, tp) mesh named ("dp", "tp") over ranks 0 .. dp*tp - 1, row by
    row. tp defaults to world // dp. Every rank of the world calls it (its
    process groups are made collectively). `device_type` defaults to the
    rank's device (`distributed.rank_device`)."""
    from .distributed import rank_device
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        tp = world // dp
    if tp * dp > world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have {world}")
    ranks = torch.arange(dp * tp, dtype=torch.int).reshape(dp, tp)
    return DeviceMesh(device_type or rank_device().type, ranks,
                      mesh_dim_names=("dp", "tp"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def shard(mesh: DeviceMesh, x: torch.Tensor, dim: int,
          axis: str = "tp") -> torch.Tensor:
    """This rank's 1/n slice of x along `dim`, n the size of `axis` (a
    contiguous copy)."""
    from .sharding import split_axis
    return split_axis(x, dim, mesh.get_local_rank(axis), axis_size(mesh, axis))


def replicate(mesh: DeviceMesh, x: torch.Tensor,
              axes=("dp", "tp")) -> torch.Tensor:
    """Broadcast x in place from the first rank of each named axis in turn
    (both axes by default: every rank of the mesh then holds rank (0, 0)'s
    x); returns x."""
    for axis in axes:
        group = mesh.get_group(axis)
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x
