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
                           slice of the cotangent backward. With
                           `own_parts` each rank reads its own part of
                           the gathered tensor (Mamba's `in_proj`,
                           whose column blocks are not the rank's
                           channels): the cotangent reduce-scattered
  scatter_to_model(x, d)   reduce-scatter along dim d forward (the
                           partial products of a row-parallel matmul,
                           each rank keeping its block of the sum: the
                           RWKV channel mix); all-gather backward
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
sharded form only where the leaf is a block. Every family of the
registry runs so: attention (GQA / MQA or MLA; Whisper's encoder and
its cross-attention, Qwen2-VL's M-RoPE), Mamba and RWKV-6 blocks, each
with a dense or MoE FFN.

Training and serving run in the same scope. In serving the logits stay
vocab-parallel through the model, and a step gathers only the positions
it reads (`gather_logits`). A serving step also splits its batch rows
over "data" (`scope(mesh, rows_over_data=True)`); the MoE block then
routes the rows of every data index together (`rows_over_data`), as the
reference routes its global batch. In parallel-mode training "data" is the
client axis, and each client routes its own batch.

FSDP (`scope(..., specs=)`, the UNSTACKED spec tree of
`sharding.param_pspecs(..., fsdp=True)`): a rank then holds its blocks
of every leaf on both axes, and the model code gathers a group's leaves
over "data" just before the group runs (`gather_params`), so the
Megatron code above sees the model-sharded blocks it sees without FSDP:

  gather_from_data(x, d)   all-gather over "data" along the leaf's FSDP
                           dim d forward; backward, the cotangent
                           reduce-scattered along d where the scope
                           splits the rows over "data" (each data rank
                           differentiates its own rows' loss), this
                           rank's slice of it where the rows are
                           replicated (B % D != 0: a sum would count the
                           gradient D times)
  copy_to_data(x)          a leaf with no FSDP dim: identity forward;
                           the cotangent summed over "data" where the
                           rows are split
  reduce_from_data(x)      the loss over split rows: all-reduce forward,
                           identity backward

The data-axis collectives of these run under the mesh's "fsdp" scope.
The sequential round and the FSDP serving steps enter such a scope
(`core/fl.py`, `launch/steps.py`). With `seq_over_data` the decode
cache's sequence dim is a block of positions over "data" (a batch that
does not split there, long_500k's B = 1): attention combines its ranks'
partial softmaxes as flash-decoding does (`combine_over_data`). The
cross-attention cache's encoder positions follow their own length
(`cross_over_data`): on "data" where it divides there, else whole on
every rank, whatever the self-attention cache does.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch.core import treemath
from repro_torch.models import sharding

MODEL_AXES = ("model",)
DATA_AXES = ("data",)
SCOPE = "tp"
FSDP_SCOPE = "fsdp"


class _Scope(NamedTuple):
    mesh: object
    rows_over_data: bool
    specs: object
    seq_over_data: bool
    cross_over_data: bool


_SCOPES: list = []  # the _Scopes entered


@contextlib.contextmanager
def scope(mesh, *, rows_over_data: bool = False, specs=None,
          seq_over_data: bool = False, cross_over_data: bool = False):
    """Run model code inside with its model-sharded leaves as this
    rank's blocks over `mesh`'s "model" axis. With `rows_over_data` the
    batch rows are split over "data" (serving; the sequential round),
    and the blocks that mix rows (the MoE's routing) see every data
    index's rows. `specs`, the UNSTACKED spec tree of the params, puts
    their FSDP dims on "data": each group's leaves are gathered over
    "data" where it runs. With `seq_over_data` the decode cache holds a
    block of the positions; with `cross_over_data` the cross-attention
    cache a block of the encoder's."""
    _SCOPES.append(_Scope(mesh, rows_over_data, specs, seq_over_data,
                          cross_over_data))
    try:
        yield mesh
    finally:
        _SCOPES.pop()


def active():
    """The mesh of the innermost scope when it has more than one rank
    (on either axis), else None (every operator is then the
    identity)."""
    if _SCOPES and _SCOPES[-1].mesh is not None \
            and _SCOPES[-1].mesh.size > 1:
        return _SCOPES[-1].mesh
    return None


def rows_over_data():
    """The mesh of the innermost scope when it splits the batch rows over
    a "data" axis of more than one rank, else None."""
    mesh = active()
    if mesh is not None and _SCOPES[-1].rows_over_data \
            and mesh.client_size > 1:
        return mesh
    return None


def seq_over_data():
    """The mesh of the innermost scope when the decode cache's sequence
    is split over a "data" axis of more than one rank, else None."""
    mesh = active()
    if mesh is not None and _SCOPES[-1].seq_over_data \
            and mesh.client_size > 1:
        return mesh
    return None


def cross_over_data():
    """The mesh of the innermost scope when the cross-attention cache's
    encoder positions are split over a "data" axis of more than one
    rank, else None."""
    mesh = active()
    if mesh is not None and _SCOPES[-1].cross_over_data \
            and mesh.client_size > 1:
        return mesh
    return None


def param_specs():
    """The innermost scope's UNSTACKED param spec tree where its "data"
    axis has more than one rank (FSDP), else None."""
    mesh = active()
    if mesh is None or mesh.client_size == 1:
        return None
    return _SCOPES[-1].specs


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


# ---------------------------------------------------- the collectives
#
# Each Function takes the mesh, the axes it spans and the scope its
# collective is recorded under (`_label`): "tp" on "model", "fsdp" for
# the params and the loss over "data", "tp" for the MoE's row gather.


def _label(axes: tuple) -> str:
    return SCOPE if axes == MODEL_AXES else FSDP_SCOPE


def _index(mesh, axes: tuple) -> int:
    return mesh.model_index if axes == MODEL_AXES else mesh.client_index


def _axis_size(mesh, axes: tuple) -> int:
    return mesh.model_size if axes == MODEL_AXES else mesh.client_size


def _sum(x, mesh, axes, label, op="sum"):
    out = x.contiguous().clone()
    with mesh.scope(label):
        return mesh.all_reduce(out, axes=axes, op=op)


def _gather(x, dim, mesh, axes, label):
    with mesh.scope(label):
        return mesh.all_gather(x, axes=axes, dim=dim)


def _scatter(x, dim, mesh, axes, label):
    with mesh.scope(label):
        return mesh.reduce_scatter(x, axes=axes, dim=dim)


def _slice(x, dim, mesh, axes):
    step = x.shape[dim] // _axis_size(mesh, axes)
    return x.narrow(dim, _index(mesh, axes) * step, step).contiguous()


def _batched_first(x, bdim):
    """(x with its vmapped dim first, that dim) for a dim-indexed op."""
    return (x, None) if bdim is None else (x.movedim(bdim, 0), 0)


class _Copy(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, mesh, axes, label):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, ct):
        return _Reduce.apply(ct, *ctx.args), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, label):
        return _Copy.apply(x, mesh, axes, label), in_dims[0]


class _Reduce(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, mesh, axes, label):
        return _sum(x, mesh, axes, label)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, ct):
        return _Copy.apply(ct, *ctx.args), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, label):
        return _Reduce.apply(x, mesh, axes, label), in_dims[0]


class _Gather(torch.autograd.Function):
    """All-gather forward; this rank's slice of the cotangent backward."""
    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, mesh, axes, label):
        return _gather(x, dim, mesh, axes, label)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, ct):
        return (_Slice.apply(ct, *ctx.args),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh, axes, label):
        x, bdim = _batched_first(x, in_dims[0])
        return _Gather.apply(x, dim + (bdim is not None), mesh, axes,
                             label), bdim


class _Slice(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, mesh, axes, label):
        return _slice(x, dim, mesh, axes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, ct):
        return (_Gather.apply(ct, *ctx.args),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh, axes, label):
        x, bdim = _batched_first(x, in_dims[0])
        return _Slice.apply(x, dim + (bdim is not None), mesh, axes,
                            label), bdim


class _GatherSum(torch.autograd.Function):
    """All-gather forward; the cotangent reduce-scattered backward."""
    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, mesh, axes, label):
        return _gather(x, dim, mesh, axes, label)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, ct):
        return (_Scatter.apply(ct, *ctx.args),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh, axes, label):
        x, bdim = _batched_first(x, in_dims[0])
        return _GatherSum.apply(x, dim + (bdim is not None), mesh, axes,
                                label), bdim


class _Scatter(torch.autograd.Function):
    """Reduce-scatter forward; the cotangent all-gathered backward."""
    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, mesh, axes, label):
        return _scatter(x, dim, mesh, axes, label)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, ct):
        return (_GatherSum.apply(ct, *ctx.args),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh, axes, label):
        x, bdim = _batched_first(x, in_dims[0])
        return _Scatter.apply(x, dim + (bdim is not None), mesh, axes,
                              label), bdim


class _Max(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, mesh, axes, label):
        return _sum(x, mesh, axes, label, op="max")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, label):
        return _Max.apply(x, mesh, axes, label), in_dims[0]


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x as it is; in the backward its cotangent summed over "model"."""
    mesh = active()
    return x if mesh is None else _Copy.apply(x, mesh, MODEL_AXES,
                                               SCOPE)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over "model"; in the backward the cotangent as it is."""
    mesh = active()
    return x if mesh is None else _Reduce.apply(x, mesh, MODEL_AXES,
                                                 SCOPE)


def gather_from_model(x: torch.Tensor, dim: int, *,
                      own_parts: bool = False) -> torch.Tensor:
    """Every model rank's x joined along `dim` in rank order; in the
    backward this rank's slice of the cotangent, which every rank holds
    alike. With `own_parts` each rank reads a part of its own of the
    result, so the cotangents differ: the backward sums them over
    "model" and keeps this rank's slice (a reduce-scatter)."""
    mesh = active()
    if mesh is None:
        return x
    fn = _GatherSum if own_parts else _Gather
    return fn.apply(x, dim % x.dim(), mesh, MODEL_AXES, SCOPE)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of x summed over "model" (the
    partial products of a row-parallel matmul of which each rank keeps
    a block); in the backward the ranks' cotangents of their blocks
    gathered."""
    mesh = active()
    if mesh is None:
        return x
    return _Scatter.apply(x, dim % x.dim(), mesh, MODEL_AXES, SCOPE)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of x over "model", without a gradient."""
    mesh = active()
    x = x.detach()
    return x if mesh is None else _Max.apply(x, mesh, MODEL_AXES, SCOPE)


def block_start(local: int) -> int:
    """The first global index of this rank's block of a dim of which it
    holds `local`."""
    return model_index() * local


def vocab_start(local: int, whole: int) -> Optional[int]:
    """This rank's first vocabulary id when the vocab dim is split (its
    `local` rows of `whole`), else None."""
    return None if split(local, whole) == 1 else block_start(local)


def gather_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Whole logits (..., vocab) from this rank's vocab block of them
    (the model's output inside a scope); whole logits as they are. A
    caller slices the positions it reads first: serving never gathers
    (B, T, V)."""
    if split(logits.shape[-1], vocab) == 1:
        return logits
    return gather_from_model(logits, -1)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data index's rows of x (dim 0) in data-index order, where
    the scope splits rows over "data"; x as it is otherwise. In the
    backward the cotangent of the gathered rows goes back to the rows'
    owner, summed over the data ranks (a reduce-scatter)."""
    mesh = rows_over_data()
    if mesh is None:
        return x
    return _GatherSum.apply(x, 0, mesh, DATA_AXES, SCOPE)


def own_rows(x: torch.Tensor, local: int) -> torch.Tensor:
    """This data index's `local` rows of x (dim 0) joined by
    `gather_rows`; x as it is where rows are not split."""
    mesh = rows_over_data()
    if mesh is None:
        return x
    return x.narrow(0, mesh.client_index * local, local)


# ------------------------------------------------------------------ FSDP


def data_dim(spec: tuple) -> int:
    """The dim a spec puts on "data" (its FSDP dim), or -1."""
    for d, entry in enumerate(spec):
        if "data" in sharding.entry_axes(entry):
            return d
    return -1


def gather_from_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every data rank's block of a leaf joined along its FSDP dim
    `dim`; in the backward the cotangent reduce-scattered over "data"
    where the scope splits the rows, this rank's slice of it where they
    are replicated (module docstring)."""
    mesh = active()
    if mesh is None or mesh.client_size == 1:
        return x
    fn = _GatherSum if rows_over_data() is not None else _Gather
    return fn.apply(x, dim % x.dim(), mesh, DATA_AXES, FSDP_SCOPE)


def copy_to_data(x: torch.Tensor) -> torch.Tensor:
    """x as it is; in the backward its cotangent summed over "data" where
    the scope splits the rows (a leaf every data rank holds whole, whose
    gradient each rank takes from its own rows)."""
    mesh = rows_over_data()
    return x if mesh is None else _Copy.apply(x, mesh, DATA_AXES,
                                               FSDP_SCOPE)


def reduce_from_data(x: torch.Tensor) -> torch.Tensor:
    """x summed over "data" where the scope splits the rows; in the
    backward the cotangent as it is."""
    mesh = rows_over_data()
    return x if mesh is None else _Reduce.apply(x, mesh, DATA_AXES,
                                                 FSDP_SCOPE)


def gather_params(tree, specs, lead: int = 0):
    """`tree`'s leaves whole over "data" inside an FSDP scope: a leaf
    whose spec (in `specs`, the tree's part of the UNSTACKED spec tree)
    puts a dim on "data" through `gather_from_data`, any other through
    `copy_to_data`. `lead` is the number of leading dims the leaves have
    lost against their specs (1 for a group's slice of stacked blocks).
    The tree as it is outside such a scope."""
    if specs is None or param_specs() is None:
        return tree
    leaves, treedef = treemath.tree_flatten(tree)
    out = []
    for x, spec in zip(leaves, treemath.tree_leaves_like(tree, specs)):
        d = data_dim(spec)
        out.append(gather_from_data(x, d - lead) if d >= 0
                   else copy_to_data(x))
    return treemath.tree_unflatten(treedef, out)


def rows_mean(total: torch.Tensor, count: torch.Tensor,
              aux: torch.Tensor) -> torch.Tensor:
    """The loss over every data index's rows, total / count + aux, where
    `total` sums this rank's tokens' losses over `count` tokens (f32).
    Where the scope splits the rows over "data" the count is summed over
    "data" and so is total / count; the aux loss, which every data rank
    computes alike from all the rows, enters each rank's part divided by
    the axis's size, so that the sum (and the reduce-scattered gradient)
    counts it once. The value is the same on every rank."""
    mesh = rows_over_data()
    if mesh is None:
        return total / torch.clamp(count, min=1.0) + aux
    count = _Reduce.apply(count.detach(), mesh, DATA_AXES, FSDP_SCOPE)
    return reduce_from_data(total / torch.clamp(count, min=1.0)
                            + aux / mesh.client_size)


def own_positions(c: torch.Tensor, cross: bool = False) -> torch.Tensor:
    """This rank's block of a prefill cache's positions (dim 1) where the
    scope puts the sequence on "data" (`cross`: the cross-attention
    cache's encoder positions); the cache as it is otherwise."""
    mesh = cross_over_data() if cross else seq_over_data()
    if mesh is None:
        return c
    step = c.shape[1] // mesh.client_size
    return c.narrow(1, mesh.client_index * step, step).clone()


def seq_blocks() -> int:
    """How many blocks over "data" a decode cache's sequence is cut in."""
    mesh = seq_over_data()
    return 1 if mesh is None else mesh.client_size


def seq_block(local: int) -> int:
    """The first global position of this rank's block of a decode cache
    whose sequence holds `local` positions a rank (0 unless the scope
    puts the sequence on "data")."""
    mesh = seq_over_data()
    return 0 if mesh is None else mesh.client_index * local


def combine_over_data(scores: torch.Tensor, valid: torch.Tensor, values,
                      cross: bool = False):
    """The attention of a decode step over the positions of every data
    rank, each holding a block of them (`seq_over_data`; `cross`: the
    encoder positions of the cross-attention cache, `cross_over_data`),
    as flash-decoding combines its splits: scores (..., S_loc) f32 and
    `valid` masking this rank's positions; `values(p)` is this rank's
    partial output for weights p (..., S_loc). One all-reduce of the
    maxima over "data", then one of the exp-sums and the partial
    outputs. Returns (output, sums): the summed partial outputs and the
    summed exp-sums (...,), by which the caller divides them."""
    mesh = cross_over_data() if cross else seq_over_data()
    scores = torch.where(valid, scores, -1e30)
    top = torch.amax(scores, dim=-1, keepdim=True)
    with mesh.scope(SCOPE):
        top = mesh.all_reduce(top.contiguous(), axes=DATA_AXES, op="max")
    p = torch.where(valid, torch.exp(scores - top), 0.0)
    sums = torch.sum(p, dim=-1)
    part = values(p)
    packed = torch.cat([sums.reshape(-1), part.reshape(-1)])
    with mesh.scope(SCOPE):
        packed = mesh.all_reduce(packed, axes=DATA_AXES)
    n = sums.numel()
    return packed[n:].reshape(part.shape), packed[:n].reshape(sums.shape)
