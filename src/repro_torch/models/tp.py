"""Tensor-parallel model execution over a mesh's "model" axis: the
collectives the model code runs when a rank holds only its blocks of
the model-sharded leaves (`models/sharding.py`).

The reference leaves this to XLA's partitioner (GSPMD): its round jits
the clients' forward and backward on params placed by `param_pspecs`,
and the compiler inserts the collectives. The port writes them out, as
Megatron-LM does (arXiv:1909.08053):

  copy_to_model(x)         identity forward; the cotangent all-reduced
                           over "model" (x is replicated, and each rank
                           reads it through its own blocks)
  reduce_from_model(x)     all-reduce forward (the partial products of a
                           row-parallel matmul); identity backward
  gather_from_model(x, d)  all-gather along dim d forward (a projection
                           whose blocks do not hold whole heads, or an
                           embedding split on its columns); this rank's
                           slice of the cotangent backward
  max_over_model(x)        the elementwise max over "model", no gradient
                           (the detached max of a vocab-parallel
                           softmax)

Each is a `torch.autograd.Function` with an explicit `vmap` rule that
runs the collective once on the physical tensor, so the K clients of
`torch.func.vmap(grad(loss))` share one collective, as they share one
flash launch. A backward never calls `torch.distributed`: under
`vmap(grad)` it is vmapped itself and sees batched tensors, so it
applies the partner Function, whose `vmap` rule unwraps them. A
collective writes into a fresh tensor, never into one autograd saved.

The model code finds its mesh through `scope(mesh)`, which the round
enters around client training (the reference's `set_constraint_mesh`
does the same for its in-model constraints). Outside a scope, or on a
model axis of one rank, every operator is the identity. The collectives
run under the mesh's "tp" scope, so `ClientMesh.recording()` lists them
apart from the round's.

A leaf's split is read from its local width against the config: the
model code compares each leaf's shape with the global one and runs the
sharded form only where the leaf is a block. Families whose blocks the
port cannot split raise `NotImplementedError` (`check_supported`).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

MODEL_AXES = ("model",)
SCOPE = "tp"
UNSUPPORTED = ("ROADMAP Queue 1 item 13d: tensor-parallel execution of "
               "this family (expert parallelism for MoE, MLA, Mamba, "
               "RWKV-6, Whisper's encoder and cross-attention, Qwen2-VL's "
               "prefix) and of serving")

_MESHES: list = []  # the meshes of the scopes entered, innermost last


@contextlib.contextmanager
def scope(mesh):
    """Run model code inside with its model-sharded leaves as this
    rank's blocks over `mesh`'s "model" axis."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def active():
    """The mesh of the innermost scope when its model axis has more than
    one rank, else None (every operator is then the identity)."""
    if _MESHES and _MESHES[-1] is not None \
            and _MESHES[-1].model_size > 1:
        return _MESHES[-1]
    return None


def model_size() -> int:
    mesh = active()
    return 1 if mesh is None else mesh.model_size


def model_index() -> int:
    mesh = active()
    return 0 if mesh is None else mesh.model_index


def split(local: int, whole: int) -> int:
    """How many blocks a dim of `whole` is cut into, given the `local`
    width this rank holds: 1 (whole) or the model axis's size."""
    if local == whole:
        return 1
    m = model_size()
    if local * m != whole:
        raise ValueError(f"a block of {local} of a dim of {whole} is not "
                         f"one of {m} blocks over the model axis")
    return m


def check_supported(cfg) -> None:
    """Raise NotImplementedError (naming item 13d) for a config whose
    blocks tensor-parallel execution does not cover, inside a scope of
    more than one model rank: the port never falls back to whole
    models there."""
    if active() is None:
        return
    dense = (cfg.moe is None and cfg.mla is None and cfg.ssm is None
             and cfg.rwkv is None and not cfg.encoder_layers
             and not cfg.vision_prefix and cfg.rope_style != "mrope"
             and all(kind == "attn" and not is_moe
                     for kind, is_moe in cfg.layer_kinds()))
    if not dense:
        raise NotImplementedError(
            f"{cfg.name}: {UNSUPPORTED}; the dense decoder-only configs "
            "run tensor-parallel")


# ---------------------------------------------------- the collectives


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    out = x.contiguous().clone()
    with mesh.scope(SCOPE):
        return mesh.all_reduce(out, axes=MODEL_AXES)


def _max(x: torch.Tensor, mesh) -> torch.Tensor:
    out = x.contiguous().clone()
    with mesh.scope(SCOPE):
        return mesh.all_reduce(out, axes=MODEL_AXES, op="max")


def _gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    with mesh.scope(SCOPE):
        return mesh.all_gather(x, axes=MODEL_AXES, dim=dim)


def _slice(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    step = x.shape[dim] // mesh.model_size
    return x.narrow(dim, mesh.model_index * step, step).contiguous()


def _batched_first(x, bdim):
    """(x with its vmapped dim first, that dim) for a dim-indexed op."""
    return (x, None) if bdim is None else (x.movedim(bdim, 0), 0)


class _Copy(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return _Reduce.apply(ct, ctx.mesh), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _Copy.apply(x, mesh), in_dims[0]


class _Reduce(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return _Copy.apply(ct, ctx.mesh), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _Reduce.apply(x, mesh), in_dims[0]


class _Gather(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, mesh):
        return _gather(x, dim, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.mesh = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, ct):
        return _Slice.apply(ct, ctx.dim, ctx.mesh), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh):
        x, bdim = _batched_first(x, in_dims[0])
        return _Gather.apply(x, dim + (bdim is not None), mesh), bdim


class _Slice(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, mesh):
        return _slice(x, dim, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.mesh = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, ct):
        return _Gather.apply(ct, ctx.dim, ctx.mesh), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh):
        x, bdim = _batched_first(x, in_dims[0])
        return _Slice.apply(x, dim + (bdim is not None), mesh), bdim


class _Max(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, mesh):
        return _max(x, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _Max.apply(x, mesh), in_dims[0]


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x as it is; in the backward its cotangent summed over "model"."""
    mesh = active()
    return x if mesh is None else _Copy.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over "model"; in the backward the cotangent as it is."""
    mesh = active()
    return x if mesh is None else _Reduce.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's x joined along `dim` in rank order; in the
    backward this rank's slice of the cotangent."""
    mesh = active()
    if mesh is None:
        return x
    return _Gather.apply(x, dim % x.dim(), mesh)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of x over "model", without a gradient."""
    mesh = active()
    x = x.detach()
    return x if mesh is None else _Max.apply(x, mesh)


def block_start(local: int) -> int:
    """The first global index of this rank's block of a dim of which it
    holds `local`."""
    return model_index() * local


def vocab_start(local: int, whole: int) -> Optional[int]:
    """This rank's first vocabulary id when the vocab dim is split (its
    `local` rows of `whole`), else None."""
    return None if split(local, whole) == 1 else block_start(local)
