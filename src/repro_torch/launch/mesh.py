"""Meshes: the client mesh that `FLConfig(engine="flat_sharded")` splits
a round's client axis over, and the abstract production mesh of the
launch layer (`launch/steps.py`, `launch/dryrun.py`).

The counterpart of `repro/launch/mesh.py`. A `ClientMesh` holds a
`torch.distributed` process group, this process's rank in it, the
group's size and the device its tensors live on. It has no model axis:
the 2D (client x model) layout is not ported yet (ROADMAP Queue 1 item
13b; `core.fl_shard_map.make_round_ops_2d` raises).

Every rank runs the same round on the same global arguments, as every
process of a multi-controller JAX program does; the round's schedule
(`core.fl_shard_map`) uses two collectives, `all_reduce` (the
reference's `psum`) and `broadcast`, the two that gloo also takes on
CUDA tensors. The backend is the caller's: NCCL across cards, gloo on
the CPU and for two ranks that share one card:

    torch.distributed.init_process_group("nccl")  # under torchrun
    mesh = make_client_mesh()                   # cuda:<LOCAL_RANK>

`make_host_mesh()` is a world of one without a process group.

`make_production_mesh()` is an `AbstractMesh`: axis names and sizes, no
devices and no process group, which the sharding rules
(`models/sharding.py`) and the step builders read as they read a JAX
mesh. It is a cluster of H100 SXM cards: the "model" axis spans one
HGX node's 8 NVLink-connected cards, "data" 32 nodes (256 cards), and
`multi_pod` a second such cluster on "pod" (512 cards), the device
counts of the reference's 16 x 16 and 2 x 16 x 16 TPU v5e pods.
"""
from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict
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

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """The mesh's axes as the sharding rules read them: the ranks
        are the "data" (client) axis; there is no model axis yet."""
        return OrderedDict((("data", self.size), ("model", 1)))

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

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


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices and no process group: what
    the sharding rules and the step builders read of a mesh (`.shape`,
    `.axis_names`, `.size`), as of `jax.sharding.AbstractMesh`."""

    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The device count."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The H100 cluster's mesh: (data, model) = (32, 8), 256 cards (one
    HGX node of 8 NVLink-connected cards on "model"); multi_pod adds a
    second cluster on "pod": (2, 32, 8), 512 cards."""
    if multi_pod:
        return AbstractMesh((2, 32, 8), ("pod", "data", "model"))
    return AbstractMesh((32, 8), ("data", "model"))


# H100 SXM constants for the roofline and the fits check, per card
# (NVIDIA's H100 Tensor Core GPU datasheet, SXM5 column)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s per direction a card (NVLink 4, 900 GB/s total)
# device memory as torch.cuda.get_device_properties(0).total_memory
# reports it on an H100 80GB HBM3 (chip_smoke.py prints it)
HBM_BYTES = 85_017_493_504
