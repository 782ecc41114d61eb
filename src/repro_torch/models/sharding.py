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
for checkpoints and hashes only. `transformer.init_params(...,
mesh=, specs=)` makes the blocks straight from the init, leaf by leaf
(`block`), so that no process holds the whole model. The activations
need no constraint: a tensor is either replicated or one of this rank's
explicit blocks, so `constrain` changes nothing.

The decode cache has rules of its own (`cache_pspecs`, the reference's
`launch/steps.py::_cache_shardings`): its batch rows over the batch
axes, its KV heads over "model" where they divide. `shard_params` and
`gather_params` move a cache tree between whole and this rank's blocks
as they move the params.
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


def shard_params(tree: PyTree, mesh, specs: PyTree) -> PyTree:
    """This rank's blocks of a whole tree under its UNSTACKED spec tree
    (`param_pspecs`, or `cache_pspecs` for a decode cache): each leaf
    cut by `block` to `NamedSpec(mesh, spec).shard_shape`; a leaf that
    is not cut as it is. Each block is a copy, so the whole leaf can be
    freed."""
    leaves, treedef = treemath.tree_flatten(tree)
    return treemath.tree_unflatten(treedef, [
        block(x, mesh, s) for x, s in zip(
            leaves, treemath.tree_leaves_like(tree, specs))])


def gather_params(blocks: PyTree, mesh, specs: PyTree,
                  device=None) -> PyTree:
    """Whole leaves from every rank's `blocks` (the inverse of
    `shard_params`, for params and caches alike): one all_gather a
    sharded axis of a leaf, leaf by leaf, each whole leaf moved to
    `device` (default: the blocks') before the next is gathered. For
    checkpoints, hashes and checks; never on the round or serving
    path."""
    leaves, treedef = treemath.tree_flatten(blocks)
    out = []
    for x, spec in zip(leaves, treemath.tree_leaves_like(blocks, specs)):
        for dim, entry in enumerate(spec):
            for axis in _names(entry):
                if _axis_size(mesh, axis) > 1:
                    x = mesh.all_gather(x, axes=(axis,), dim=dim)
        out.append(x if device is None else x.to(device))
    return treemath.tree_unflatten(treedef, out)


def _axis_index(mesh, axis: str) -> int:
    """This rank's index on `axis` of a `launch.mesh.ClientMesh`."""
    if axis == "model":
        return mesh.model_index
    if axis == "data":
        return mesh.client_index
    raise ValueError(f"a ClientMesh has no axis {axis!r}")


def block(x, mesh, spec: tuple):
    """This rank's block of the whole leaf `x` under `spec` on a
    `ClientMesh`: each sharded dim cut to the rank's index on its axis,
    of `NamedSpec(mesh, spec).shard_shape`. A copy where it is cut, so
    the whole leaf can be freed; `x` itself where nothing is."""
    out = x
    for dim, entry in enumerate(spec):
        for axis in _names(entry):
            n = _axis_size(mesh, axis)
            if n > 1:
                step = out.shape[dim] // n
                out = out.narrow(dim, _axis_index(mesh, axis) * step, step)
    NamedSpec(mesh, spec).shard_shape(tuple(x.shape))  # raises off blocks
    return x if out is x else out.clone()


def spec_at(specs: PyTree, keys: tuple) -> tuple:
    """The spec of the leaf at dict path `keys` of a spec tree."""
    for k in keys:
        specs = specs[k]
    return specs


def cache_pspecs(cache_or_shapes: PyTree, mesh) -> PyTree:
    """Decode-cache rules, the reference's `_cache_shardings`: batch dim
    over (pod, data); if B is unshardable (long_500k B = 1) the sequence
    dim of attention caches goes on "data"; the K / V heads on "model"
    where they divide; SSM inner dims follow their params onto "model".
    The MLA latents have no head dim and stay whole on "model"."""
    total = batch_total(mesh)
    msize = _axis_size(mesh, "model")
    baxes = batch_spec_entry(mesh)

    def leaf(keys, x):
        name = keys[-1]
        shape = tuple(x.shape)
        nd = len(shape)
        spec: list = [None] * nd
        # dim0 = scan group axis (never sharded); dim1 = batch
        if nd >= 2 and shape[1] % total == 0 and shape[1] >= total:
            spec[1] = baxes
        elif name in ("k", "v", "ckv", "krope", "cross_k", "cross_v") \
                and nd >= 3:
            if shape[2] % _axis_size(mesh, "data") == 0:
                spec[2] = "data"
        if name in ("k", "v", "cross_k", "cross_v") and nd >= 4:
            if shape[3] % msize == 0 and shape[3] >= msize:
                spec[3] = "model"
        if name == "h" and nd >= 3 and shape[2] % msize == 0:
            spec[2] = "model"
        if name == "conv" and nd >= 4 and shape[3] % msize == 0:
            spec[3] = "model"
        if name == "S" and nd >= 3 and shape[2] % msize == 0:
            spec[2] = "model"  # rwkv heads
        return tuple(spec)

    return map_leaves(leaf, cache_or_shapes)
