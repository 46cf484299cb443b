"""Multi-process runtime helpers, the port of the JAX package's
`parallel/distributed.py`.

One process per card (torchrun's layout): each rank joins the process
group, owns one device, and a (dp, tp) mesh spans the world with dp laid
out across hosts and tp within a host, so tensor-parallel collectives stay
on a host's NVLink. Single-process use degenerates cleanly:
`init_distributed()` is a no-op for a world of one.

The backend is the caller's: NCCL for cards by default, gloo for
`device="cpu"` or when named (`backend="gloo"`, which also moves CUDA
tensors, through the host: ranks that share one card, which NCCL refuses).
Nothing here switches backend on its own.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_device: Optional[torch.device] = None


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join (or skip) the torch.distributed world.

    Arguments default from torchrun's environment (WORLD_SIZE, RANK,
    LOCAL_RANK, and MASTER_ADDR / MASTER_PORT for the default `env://`
    rendezvous). Returns True once a multi-process world is joined, False
    for a world of one or no rendezvous address (nothing is initialized).
    The rank's device is `device`, else cuda:LOCAL_RANK (raises when that
    card does not exist); the backend is `backend`, else NCCL for a card and
    gloo for the CPU."""
    global _device
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 or (init_method is None
                           and "MASTER_ADDR" not in os.environ):
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = torch.device(device if device is not None else f"cuda:{local_rank}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if not torch.cuda.is_available() or dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: {dev} does not exist (CUDA available: "
                f"{torch.cuda.is_available()}, {torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                f"cards); pass device='cpu' with backend 'gloo' to run on the CPU")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _device = dev
    return True


def rank_device() -> torch.device:
    """The device init_distributed gave this rank; outside a world, cuda
    (raising without a card, see common.default_device)."""
    from ..common import default_device
    return _device if _device is not None else default_device()


def serving_mesh(tp: Optional[int] = None) -> DeviceMesh:
    """Global (dp, tp) mesh for batched serving.

    tp defaults to the ranks of one host (LOCAL_WORLD_SIZE, so tensor-
    parallel collectives stay within a host); dp = world / tp spans hosts.
    Ranks are ordered host-major (by GROUP_RANK, torchrun's node rank, then
    by rank) so each dp row is one host's ranks. Every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("serving_mesh needs an initialized process group "
                           "(init_distributed)")
    world = dist.get_world_size()
    if tp is None:
        tp = min(int(os.environ.get("LOCAL_WORLD_SIZE", str(world))), world)
    if world % tp:
        raise ValueError(f"{world} ranks not divisible by tp={tp}")
    node = int(os.environ.get("GROUP_RANK", "0"))
    keys = [None] * world
    dist.all_gather_object(keys, (node, dist.get_rank()))
    order = [r for _, r in sorted(keys)]
    ranks = torch.tensor(order, dtype=torch.int).reshape(world // tp, tp)
    return DeviceMesh(rank_device().type, ranks, mesh_dim_names=("dp", "tp"))


def host_slot_range(n_slots_total: int, group=None) -> range:
    """Which continuous-batching slots this rank owns: n_slots_total split
    evenly over the ranks of `group` (default the world; the dp group of a
    serving mesh gives each dp row its share), the last taking the rest."""
    if not dist.is_initialized():
        return range(n_slots_total)
    n_proc = dist.get_world_size(group)
    me = dist.get_rank(group)
    per = n_slots_total // n_proc
    lo = me * per
    hi = n_slots_total if me == n_proc - 1 else lo + per
    return range(lo, hi)


def group_rank_size(group=None) -> tuple[int, int]:
    """(this rank's index, size) in `group` (None: the world); (0, 1)
    outside a world."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum t over the ranks of `group` in place (the JAX package's
    `jax.lax.psum`); returns t. Outside a world there is nothing to sum."""
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t
