"""The client mesh: the ranks that `FLConfig(engine="flat_sharded")`
splits a round's client axis over.

The counterpart of `repro/launch/mesh.py` on the client axis only. A
`ClientMesh` holds a `torch.distributed` process group, this process's
rank in it, the group's size and the device its tensors live on. It has
no model axis: the 2D (client x model) layout is not ported yet (ROADMAP
Queue 1 item 13b; `core.fl_shard_map.make_round_ops_2d` raises).

Every rank runs the same round on the same global arguments, as every
process of a multi-controller JAX program does; the round's schedule
(`core.fl_shard_map`) uses two collectives, `all_reduce` (the
reference's `psum`) and `broadcast`, the two that gloo also takes on
CUDA tensors. The backend is the caller's: NCCL across cards, gloo on
the CPU and for two ranks that share one card:

    torch.distributed.init_process_group("nccl")  # under torchrun
    mesh = make_client_mesh()                   # cuda:<LOCAL_RANK>

`make_host_mesh()` is a world of one without a process group.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

import repro_torch

@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A client-only mesh. `group` None is a world of one that runs no
    collective (`make_host_mesh`); otherwise every collective goes
    through `group`. A mesh of more ranks without a group raises: its
    collectives would quietly be local sums."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    def __post_init__(self):
        if self.group is None and (self.size, self.rank) != (1, 0):
            raise ValueError(
                f"a ClientMesh of size {self.size} (rank {self.rank}) "
                "needs a process group; only a world of one runs without")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place (the reference's psum over
        the client axis); returns it."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank `src`'s `t` on every rank, in place; returns it."""
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, src),
                           group=self.group)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def check_device(self, device) -> None:
        """Raise ValueError unless `device` is the mesh's: a rank never
        trains or aggregates elsewhere."""
        if _placed(torch.device(device)) != _placed(self.device):
            raise ValueError(
                f"the round's tensors lie on {device}, but the mesh runs "
                f"on {self.device}")


def check_mesh(mesh) -> None:
    """Raise TypeError unless `mesh` is None or a ClientMesh."""
    if mesh is not None and not isinstance(mesh, ClientMesh):
        raise TypeError(
            f"mesh must be a repro_torch.launch.mesh.ClientMesh, not "
            f"{type(mesh).__name__}")


def _placed(device: torch.device) -> tuple:
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def make_client_mesh(group: Optional[dist.ProcessGroup] = None,
                     device=None) -> ClientMesh:
    """A ClientMesh over `group` (the default group when None), which
    `torch.distributed.init_process_group` must have made. `device` None
    means `cuda:<local rank>` (the LOCAL_RANK that torchrun sets, else
    the rank) and raises without a GPU; pass "cpu" (gloo only) or a card
    explicitly, e.g. when two gloo ranks share one card."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_client_mesh needs a process group: call "
            "torch.distributed.init_process_group first (or use "
            "make_host_mesh for a world of one)")
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    if device is None:
        repro_torch.default_device()
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    device = torch.device(device)
    if device.type != "cuda" and dist.get_backend(group) == "nccl":
        raise ValueError(
            f"the NCCL backend reduces CUDA tensors only, not {device}; "
            "use gloo for a CPU mesh")
    return ClientMesh(group=group, rank=rank,
                      size=dist.get_world_size(group), device=device)


def make_host_mesh(device=None) -> ClientMesh:
    """A world of one (no process group, no collective): the sharded
    engine on one device. `device` None means CUDA, raising without a
    GPU; "cpu" is explicit."""
    device = (repro_torch.default_device() if device is None
              else torch.device(device))
    return ClientMesh(group=None, rank=0, size=1, device=device)
