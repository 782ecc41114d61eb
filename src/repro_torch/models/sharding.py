"""Parameter / activation partition rules for the production mesh: the
counterpart of `repro/models/sharding.py`, rule for rule.

Mesh axes: ("pod", "data", "model") multi-pod or ("data", "model") single
pod (`launch/mesh.py`). Tensor parallelism lives on "model"; "data" is
the client axis (parallel FL mode) or the FSDP axis (sequential mode /
big-model serving); "pod" extends the client/data axis across pods.

A spec is a tuple like a `jax.sharding.PartitionSpec`: one entry per
leading dim, each None (replicated), an axis name or a tuple of names.
`NamedSpec(mesh, spec)` pairs it with a mesh and gives the per-device
`shard_shape`. Rules are name-based over the param tree; every block
leaf carries a leading scan-group axis which is never sharded. Dims are
only sharded when divisible by the axis size.

The rules say where each tensor lives and what one device holds: the
dry run reports them, and on a `launch.mesh.ClientMesh` with a model
axis the 2D wire reads them (`core.fl._derive_param_pspecs`): a
model-sharded leaf is raveled, quantized and aggregated a block a rank
(`core.fl_shard_map.make_round_ops_2d`). Given them as `param_specs`,
`core.fl.make_round_fn` keeps the state in this rank's blocks
(`shard_params`) and trains each client tensor-parallel over "model"
(`models/tp.py`: the model code reads each leaf's split from its
width and runs the collectives itself). `gather_params` is the inverse,
for checkpoints and hashes only. The activations need no constraint: a
tensor is either replicated or one of this rank's explicit blocks, so
`constrain` changes nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.core import treemath

PyTree = Any

# name -> which logical dim to put on the model axis, counted from the END
# of the non-group dims: "last" = output features, "first" = input features.
_LAST = {
    "w_gate", "w_up", "wq", "wk", "wv", "in_proj", "dt_w", "cw_k", "cw_r",
    "w_r", "w_k", "w_v", "w_g", "wq_b", "wk_b", "wv_b",
}
_FIRST = {"w_down", "wo", "out_proj", "x_proj", "A_log", "cw_v", "w_o"}
_REPLICATE = {
    "router", "decay_a", "decay_b", "u", "w_base", "ln_x_scale", "ln_x_bias",
    "scale", "bias", "conv_b", "dt_b", "D", "b", "kv_norm", "q_norm",
    "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cmu_k", "cmu_r", "wq_a", "wkv_a",
}


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec on a mesh (the port's `jax.sharding.NamedSharding`)."""

    mesh: Any
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape one device holds of a global `shape`; raises
        ValueError where a sharded dim does not divide."""
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in _names(entry))
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {entry} ({n} devices)")
            out[dim] //= n
        return tuple(out)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def _leaf_spec(keys: tuple, shape: tuple, mesh, fsdp: bool,
               replicate_extra: frozenset = frozenset()) -> tuple:
    model = "model" if "model" in mesh.axis_names else None
    msize = _axis_size(mesh, "model")
    dsize = _axis_size(mesh, "data")
    name = keys[-1]
    if name in replicate_extra:
        return (None,) * len(shape)
    grouped = "blocks" in keys  # leading scan-group axis
    off = 1 if grouped else 0
    nd = len(shape)
    spec: list = [None] * nd

    def try_set(dim: int, axis: str, size: int) -> bool:
        if dim < off or dim >= nd or spec[dim] is not None:
            return False
        if shape[dim] % size != 0 or shape[dim] < size:
            return False
        spec[dim] = axis
        return True

    if model is not None and nd - off >= 2 and name not in _REPLICATE:
        if name in ("w_gate", "w_up", "w_down") and nd - off == 3:
            # stacked routed experts (E, d_in, d_out): expert parallelism
            if not try_set(off, "model", msize):
                try_set(nd - 1, "model", msize)
        elif name == "embed":
            if not try_set(0, "model", msize):  # vocab
                try_set(1, "model", msize)
        elif name == "lm_head":
            if not try_set(1, "model", msize):
                try_set(0, "model", msize)
        elif name == "conv_w":
            try_set(nd - 1, "model", msize)
        elif name in _LAST:
            try_set(nd - 1, "model", msize)
        elif name in _FIRST:
            try_set(nd - 2, "model", msize)

    if fsdp and "data" in mesh.axis_names and nd - off >= 2:
        # shard the largest remaining dim over the data axis
        cand = sorted(range(off, nd), key=lambda d: -shape[d])
        for d in cand:
            if spec[d] is None and try_set(d, "data", dsize):
                break
    return tuple(spec)


def _keys(path: tuple) -> tuple:
    """A leaf's key path as the reference names it: dict keys, "" for a
    list or tuple position."""
    return tuple(k if isinstance(k, str) else "" for k in path)


def map_leaves(fn, tree: PyTree) -> PyTree:
    """`fn(keys, leaf)` over every leaf, in the tree's structure (the
    results may be tuples: they are leaves, not nodes)."""
    leaves, treedef = treemath.tree_flatten(tree)
    paths = treemath.tree_paths(tree)
    return treemath.tree_unflatten(
        treedef, [fn(_keys(p), x) for p, x in zip(paths, leaves)])


def param_pspecs(params_or_shapes: PyTree, mesh, *, fsdp: bool = False,
                 replicate_extra: frozenset = frozenset()) -> PyTree:
    """Spec tree matching the param tree.

    replicate_extra: leaf names forced to full replication — e.g. MQA k/v
    projections whose head count cannot fill the model axis.
    """
    return map_leaves(
        lambda keys, x: _leaf_spec(keys, tuple(x.shape), mesh, fsdp,
                                   replicate_extra), params_or_shapes)


def param_shardings(params_or_shapes, mesh, *, fsdp: bool = False,
                    replicate_extra: frozenset = frozenset()):
    return map_leaves(
        lambda keys, x: NamedSpec(mesh, _leaf_spec(
            keys, tuple(x.shape), mesh, fsdp, replicate_extra)),
        params_or_shapes)


def batch_axes(mesh) -> tuple:
    """Mesh axes forming the batch/client dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_spec_entry(mesh):
    """The batch axes as one spec entry: a name, or a tuple of names."""
    axes = batch_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def batch_total(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in batch_axes(mesh))


def shard_batch_dim(mesh, tree: PyTree, dim_of: Optional[dict] = None,
                    default_dim: int = 0):
    """NamedSpec tree putting the batch axes on `default_dim` of every
    leaf if divisible, else replicating."""
    total = batch_total(mesh)

    def leaf(_, x):
        spec = [None] * len(x.shape)
        d = default_dim
        if len(x.shape) > d and x.shape[d] % total == 0 and x.shape[d] >= total:
            spec[d] = batch_spec_entry(mesh)
        return NamedSpec(mesh, tuple(spec))

    return map_leaves(leaf, tree)


def replicated(mesh, tree: PyTree):
    return map_leaves(lambda _, x: NamedSpec(mesh, ()), tree)


def set_constraint_mesh(mesh) -> None:
    """The reference registers the mesh of its in-model `constrain`
    calls here. The port's model code finds its tensor-parallel mesh
    through `models.tp.scope`, which the round enters around client
    training, and `constrain` changes nothing, so the mesh is accepted
    for the reference's callers and not kept."""


def constrain(x, *axes):
    """The reference's soft in-model activation constraint: `axes` gives
    one entry per dim (None, a mesh axis name, or "batch"). Under the
    port's tensor-parallel execution (`models/tp.py`) an activation is
    replicated or an explicit block, moved only by its collectives, so
    on every mesh this returns `x` unchanged; model code may call it
    unconditionally."""
    return x


def shard_params(params: PyTree, mesh, specs: PyTree) -> PyTree:
    """This rank's blocks of whole `params` under the UNSTACKED spec tree
    `specs` (`param_pspecs`): each model-sharded leaf cut on its "model"
    dim to the block at the rank's model index, of
    `NamedSpec(mesh, spec).shard_shape`; a replicated leaf as it is.
    Each block is a copy, so the whole leaf can be freed."""
    from repro_torch.core import fl_shard_map

    blocks = fl_shard_map.local_blocks(
        mesh, treemath.tree_map(lambda x: x[None], params), specs)
    return treemath.tree_map(
        lambda b, x: b[0] if b[0].shape == x.shape else b[0].clone(),
        blocks, params)


def gather_params(blocks: PyTree, mesh, specs: PyTree,
                  device=None) -> PyTree:
    """Whole leaves from this rank's `blocks` (the inverse of
    `shard_params`): one all_gather over "model" a model-sharded leaf,
    leaf by leaf, each whole leaf moved to `device` (default: the
    blocks') before the next is gathered. For checkpoints and
    `params_sha256`; never on the round path."""
    from repro_torch.core import fl_shard_map

    leaves, treedef = treemath.tree_flatten(blocks)
    out = []
    for x, spec in zip(leaves, treemath.tree_leaves_like(blocks, specs)):
        x, = fl_shard_map.gather_model_sharded(mesh, [x], spec)
        out.append(x if device is None else x.to(device))
    return treemath.tree_unflatten(treedef, out)
