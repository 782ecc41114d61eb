"""Meshes: the client mesh that `FLConfig(engine="flat_sharded")` splits
a round over, and the abstract production mesh of the launch layer
(`launch/steps.py`, `launch/dryrun.py`).

The counterpart of `repro/launch/mesh.py`. A `ClientMesh` holds a
`torch.distributed` process group of P ranks, this process's rank in
it, and the device its tensors live on. Its ranks form a (P/M, M)
("data", "model") grid, rank r at (r // M, r % M), row-major as
`jax.make_mesh((P/M, M), ("data", "model"))` places devices; M = 1
(the default) is a client-only mesh. "data" is the client axis: the
ranks of one column share a model index j and split the cohort's rows.
"model" is the axis the 2D wire splits each client's delta over
(`core.fl_shard_map.make_round_ops_2d`): the ranks of one row hold the
same clients and one column block each of every leaf.

Every rank runs the same round on the same global arguments, as every
process of a multi-controller JAX program does. The round's schedule
(`core.fl_shard_map`) names the axes each collective spans:
`all_reduce` (the reference's `psum`), `broadcast`, and `all_gather`
over "model" (the reference's `all_gather`, which re-joins a leaf's
column blocks). The backend is the caller's: NCCL across cards, gloo on
the CPU and for ranks that share one card (gloo takes CUDA tensors in
all three):

    torch.distributed.init_process_group("nccl")   # under torchrun
    mesh = make_client_mesh(model=2)               # cuda:<LOCAL_RANK>

`make_host_mesh()` is a world of one without a process group.
`make_trace_mesh((D, M), rank)` is one rank of a (D, M) mesh on the
meta device without one (`TraceMesh`): its collectives record and
shape their results and move nothing, so the dry run traces that rank's
program (`launch/dryrun.py`).
`mesh.recording()` lists every collective the mesh runs inside it
(its axes and bytes, and the `scope` it ran in), which is how the
round's traffic is counted.

`make_production_mesh()` is an `AbstractMesh`: axis names and sizes, no
devices and no process group, which the sharding rules
(`models/sharding.py`) and the step builders read as they read a JAX
mesh. It is a cluster of H100 SXM cards: the "model" axis spans one
HGX node's 8 NVLink-connected cards, "data" 32 nodes (256 cards), and
`multi_pod` a second such cluster on "pod" (512 cards), the device
counts of the reference's 16 x 16 and 2 x 16 x 16 TPU v5e pods.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

import repro_torch

AXES = ("data", "model")


class Collective(NamedTuple):
    """One collective as `ClientMesh.recording` lists it: the op, the
    axes it spans, the shape and bytes of this rank's tensor (for an
    all_gather, the part it sends), and the scope it ran in."""

    op: str
    axes: tuple
    shape: tuple
    nbytes: int
    scope: Optional[str]


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A (data, model) mesh of `size` ranks, `model` of them on the model
    axis. `group` spans every rank; `data_group` the ranks that share
    this rank's model index, `model_group` those that share its client
    index (each None where its axis has one rank, or on a client-only
    mesh, where "data" is `group`). `group` None is a world of one that
    runs no collective (`make_host_mesh`); a mesh of more ranks without
    a group raises: its collectives would quietly be local sums."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    _log: dict = dataclasses.field(default_factory=lambda: {
        "logs": [], "scope": None}, repr=False, compare=False)

    def __post_init__(self):
        if self.group is None and (self.size, self.rank) != (1, 0):
            raise ValueError(
                f"a ClientMesh of size {self.size} (rank {self.rank}) "
                "needs a process group; only a world of one runs without")
        if self.model < 1 or self.size % self.model:
            raise ValueError(f"a model axis of {self.model} does not "
                             f"divide a mesh of {self.size} ranks")
        for axis, n, sub in (("data", self.client_size, self.data_group),
                             ("model", self.model, self.model_group)):
            if n > 1 and self.model > 1 and sub is None:
                raise ValueError(f"a (data, model) mesh needs the group "
                                 f"of its {axis!r} axis ({n} ranks)")

    @property
    def client_index(self) -> int:
        """This rank's index on the "data" (client) axis."""
        return self.rank // self.model

    @property
    def client_size(self) -> int:
        return self.size // self.model

    @property
    def model_index(self) -> int:
        """This rank's index on the "model" axis."""
        return self.rank % self.model

    @property
    def model_size(self) -> int:
        return self.model

    def _group(self, axes: tuple):
        """The group of `axes` and its size; None where it is one rank."""
        axes = tuple(axes)
        if axes == ("data", "model"):
            return self.group, self.size
        if axes == ("data",):
            n = self.client_size
            return (self.group if self.model == 1 else self.data_group), n
        if axes == ("model",):
            return self.model_group, self.model
        raise ValueError(f"unknown mesh axes {axes}; use a non-empty "
                         f"ordered subset of {AXES}")

    def axes_size(self, axes: tuple) -> int:
        """The number of ranks `axes` span."""
        return self._group(axes)[1]

    def _record(self, op: str, axes: tuple, t: torch.Tensor) -> None:
        for log in self._log["logs"]:
            log.append(Collective(op, tuple(axes), tuple(t.shape),
                                  t.numel() * t.element_size(),
                                  self._log["scope"]))

    @contextlib.contextmanager
    def recording(self):
        """A list of every collective this mesh runs inside the block
        (`Collective` entries, this rank's side), for counting a round's
        traffic. Collectives over one rank are not listed: they move
        nothing."""
        log: list = []
        self._log["logs"].append(log)
        try:
            yield log
        finally:
            self._log["logs"].remove(log)

    @contextlib.contextmanager
    def scope(self, name: str):
        """Label the collectives run inside the block `name` in every
        recording."""
        outer, self._log["scope"] = self._log["scope"], name
        try:
            yield
        finally:
            self._log["scope"] = outer

    def all_reduce(self, t: torch.Tensor, axes=("data",),
                   op: str = "sum") -> torch.Tensor:
        """Sum `t` over the ranks of `axes`, in place (the reference's
        psum over those axes), or with op="max" their elementwise
        maximum (pmax); returns it. The default is the client axis,
        which on a client-only mesh is every rank."""
        self._check(t)
        group, n = self._group(axes)
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op {op!r}: use 'sum' or 'max'")
        if n > 1:
            self._record("all_reduce", axes, t)
            self._c10d_all_reduce(t, op, group)
        return t

    def broadcast(self, t: torch.Tensor, src: int,
                  axes=("data", "model")) -> torch.Tensor:
        """The `t` of the rank at index `src` of `axes` (on both axes,
        the world rank) on every rank of them, in place; returns it."""
        self._check(t)
        group, n = self._group(axes)
        if n > 1:
            self._record("broadcast", axes, t)
            self._c10d_broadcast(t, src, group)
        return t

    def all_gather(self, t: torch.Tensor, axes=("model",),
                   dim: int = 0) -> torch.Tensor:
        """Every rank's `t` over `axes`, concatenated along `dim` in the
        axes' order (the reference's tiled all_gather); `t` itself on an
        axis of one rank."""
        self._check(t)
        group, n = self._group(axes)
        if n == 1:
            return t
        self._record("all_gather", axes, t)
        t = t.contiguous()
        # each rank's part lands in its view of the result: no parts
        # beside it, so a gathered FSDP group costs its own size only
        shape = list(t.shape)
        shape[dim] *= n
        out = t.new_empty(shape)
        step = t.shape[dim]
        self._c10d_all_gather(
            [out.narrow(dim, i * step, step) for i in range(n)], t, group)
        return out

    def reduce_scatter(self, t: torch.Tensor, axes=("data",),
                       dim: int = 0) -> torch.Tensor:
        """This rank's block along `dim` of `t` summed over the ranks of
        `axes` (the reference's psum_scatter, tiled): the partner of
        `all_gather`, a fresh tensor; `t` itself on an axis of one
        rank."""
        self._check(t)
        group, n = self._group(axes)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {n} ranks of {tuple(axes)}")
        self._record("reduce_scatter", axes, t)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        self._c10d_reduce_scatter(out, src, group)
        return out.movedim(0, dim).contiguous()

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    # The process group's half of each collective. The methods above
    # shape, allocate and record; these move the bytes (`TraceMesh`
    # moves none).

    def _check(self, t: torch.Tensor) -> None:
        """Raise for a tensor this mesh cannot run a collective on."""

    def _c10d_all_reduce(self, t, op: str, group) -> None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)

    def _c10d_broadcast(self, t, src: int, group) -> None:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)

    def _c10d_all_gather(self, parts: list, t, group) -> None:
        dist.all_gather(parts, t, group=group)

    def _c10d_reduce_scatter(self, out, src, group) -> None:
        # torch 2.13 renames reduce_scatter_tensor reduce_scatter_single
        getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
            out, src, group=group)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """The mesh's axes as the sharding rules read them."""
        return OrderedDict((("data", self.client_size),
                            ("model", self.model)))

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
                     device=None, *, model: int = 1) -> ClientMesh:
    """A ClientMesh over `group` (the default group when None), which
    `torch.distributed.init_process_group` must have made, with `model`
    ranks on its model axis. `device` None means `cuda:<local rank>`
    (the LOCAL_RANK that torchrun sets, else the rank) and raises
    without a GPU; pass "cpu" (gloo only) or a card explicitly, e.g.
    when gloo ranks share one card.

    With model > 1 the mesh spans the whole job, and every process
    must call this with the same `model`: each makes the same
    sub-groups (`dist.new_group`, every client group, then every model
    group), as that call requires of every process of the job."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_client_mesh needs a process group: call "
            "torch.distributed.init_process_group first (or use "
            "make_host_mesh for a world of one)")
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        repro_torch.default_device()
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    device = torch.device(device)
    if device.type != "cuda" and dist.get_backend(group) == "nccl":
        raise ValueError(
            f"the NCCL backend reduces CUDA tensors only, not {device}; "
            "use gloo for a CPU mesh")
    if model < 1 or size % model:
        raise ValueError(f"a model axis of {model} does not divide a "
                         f"world of {size} ranks")
    subs = {}
    if model > 1:
        if size != dist.get_world_size():
            raise ValueError("a mesh with a model axis spans the whole "
                             "job: pass group=None")
        clients = size // model
        for axis, members in (
                ("data", [[c * model + j for c in range(clients)]
                          for j in range(model)]),
                ("model", [[c * model + j for j in range(model)]
                           for c in range(clients)])):
            if len(members[0]) == 1:
                continue
            for ranks in members:  # every rank makes every group
                made = dist.new_group(ranks)
                if rank in ranks:
                    subs[axis] = made
    return ClientMesh(group=group, rank=rank, size=size, device=device,
                      model=model, data_group=subs.get("data"),
                      model_group=subs.get("model"))


def make_host_mesh(device=None) -> ClientMesh:
    """A world of one (no process group, no collective): the sharded
    engine on one device. `device` None means CUDA, raising without a
    GPU; "cpu" is explicit."""
    device = (repro_torch.default_device() if device is None
              else torch.device(device))
    return ClientMesh(group=None, rank=0, size=1, device=device)


@dataclasses.dataclass(frozen=True)
class TraceMesh(ClientMesh):
    """One rank of a (data, model) mesh of `size` ranks on the meta
    device, with no process group: the dry run's mesh
    (`launch/dryrun.py`). The step builders and the model code take it
    as the ClientMesh of a real world, so one rank's program runs on
    meta. Each collective shapes, allocates and records as a real rank's
    does (scopes included) and moves nothing: `all_reduce` and
    `broadcast` return their input, `all_gather` a fresh tensor of `dim`
    times the axis's size, `reduce_scatter` one of `dim` over it. Every
    collective raises on a tensor off the meta device: a real tensor
    would come back as a local sum."""

    def __post_init__(self):
        if self.group is not None or self.device != torch.device("meta"):
            raise ValueError("a TraceMesh runs on the meta device, with "
                             "no process group")
        if self.model < 1 or self.size % self.model:
            raise ValueError(f"a model axis of {self.model} does not "
                             f"divide a mesh of {self.size} ranks")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} of a mesh of {self.size}")

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            raise ValueError(
                f"a TraceMesh collective on a tensor on {t.device}: it "
                "traces meta tensors only, and moves no bytes")

    def _c10d_all_reduce(self, t, op, group) -> None:
        pass

    def _c10d_broadcast(self, t, src, group) -> None:
        pass

    def _c10d_all_gather(self, parts, t, group) -> None:
        pass

    def _c10d_reduce_scatter(self, out, src, group) -> None:
        pass


def make_trace_mesh(shape: tuple, rank: int = 0) -> TraceMesh:
    """Rank `rank` of a (data, model) = `shape` mesh on the meta device
    (`TraceMesh`), row-major as `make_client_mesh` places ranks."""
    data, model = shape
    return TraceMesh(group=None, rank=rank, size=data * model,
                     device=torch.device("meta"), model=model)


WORLD_MODEL_AXIS = 8  # ranks on "model": one HGX node's NVLink cards


def launcher_device(device, host_mesh: bool) -> torch.device:
    """The launchers' device: `device` when given; else CUDA on the host
    mesh, and off it this rank's card (`LOCAL_RANK`); CUDA raises
    without a GPU."""
    if device is not None:
        return torch.device(device)
    dev = repro_torch.default_device()
    if host_mesh:
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def world_mesh(dev) -> ClientMesh:
    """The launchers' mesh off the host mesh: the process group's world
    as (world / M, M) with M = min(8, world), on `dev`. Starts the group
    under torchrun (NCCL on CUDA, gloo on the CPU) unless the caller
    has."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "the launcher off the host mesh runs one rank a device on "
                "a torch.distributed world: start it under torchrun (or "
                "call torch.distributed.init_process_group first), or pass "
                "--host-mesh for one device")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size()
    model = min(WORLD_MODEL_AXIS, world)
    if world % model:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"({world // model}, {model}) (data, model)")
    return make_client_mesh(device=dev, model=model)


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
