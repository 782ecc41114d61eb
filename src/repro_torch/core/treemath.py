"""Tree linear algebra for the FL aggregation layer, on torch tensors.

The torch counterpart of `repro/core/treemath.py`. A tree is a tensor or
a nested dict / list / tuple of them (model params are `dict[str,
Tensor]`). Dict keys flatten in SORTED order, as `jax.tree_util` does,
so that the raveled (K, N) buffer and every flat vector match the JAX
package element for element (the CNN's keys sort as b1, b2, c1, c2, f1,
f2, fb1, fb2, not in `cnn_init`'s insertion order).

All reductions are computed in f32 whatever the leaf dtype.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

Tree = Any
_LEAF = None  # treedef of a single tensor


def tree_flatten(tree: Tree) -> tuple[list, Any]:
    """(leaves, treedef): leaves in sorted-key order; the treedef is
    hashable and rebuilds the structure with `tree_unflatten`."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for t in tree:
            sub, d = tree_flatten(t)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, len(tree), tuple(defs))
    return [tree], _LEAF


def tree_unflatten(treedef, leaves) -> Tree:
    return _build(treedef, iter(leaves))


def _build(d, it) -> Tree:
    # a module-level function: a recursive closure would be a reference
    # cycle holding the leaves until the cyclic collector ran
    if d is _LEAF:
        return next(it)
    kind, keys, defs = d
    children = [_build(c, it) for c in defs]
    if kind == "dict":
        return dict(zip(keys, children))
    return list(children) if kind == "list" else tuple(children)


def tree_leaves(tree: Tree) -> list:
    return tree_flatten(tree)[0]


def tree_paths(tree: Tree) -> list[tuple]:
    """One key path per leaf, in flatten order (dict keys, or list/tuple
    positions), as `jax.tree_util.tree_flatten_with_path` names them."""
    if isinstance(tree, dict):
        return [(k,) + p for k in sorted(tree) for p in tree_paths(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(i,) + p for i, t in enumerate(tree) for p in tree_paths(t)]
    return [()]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def _fdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.to(torch.float32) * y.to(torch.float32))


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """<a, b> over all leaves, accumulated in f32."""
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    assert len(leaves_a) == len(leaves_b)
    return torch.sum(torch.stack([_fdot(x, y)
                                  for x, y in zip(leaves_a, leaves_b)]))


def tree_sqnorm(a: Tree) -> torch.Tensor:
    """||a||^2 over all leaves, accumulated in f32."""
    return torch.sum(torch.stack([_fdot(x, x) for x in tree_leaves(a)]))


def tree_dot_and_norms(a: Tree, b: Tree) -> tuple:
    """(<a, b>, ||a||^2, ||b||^2) in one traversal of both trees, in
    f32."""
    dots, na, nb = [], [], []
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        dots.append(_fdot(x, y))
        na.append(_fdot(x, x))
        nb.append(_fdot(y, y))
    return (torch.sum(torch.stack(dots)), torch.sum(torch.stack(na)),
            torch.sum(torch.stack(nb)))


def global_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_sqnorm(a))


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_cast(a: Tree, dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), a)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    """a * s, computed in f32, cast back to each leaf's dtype."""
    return tree_map(lambda x: (x.to(torch.float32) * s).to(x.dtype), a)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha * x + y, computed in f32, cast back to y's dtype."""
    return tree_map(
        lambda xi, yi: (alpha * xi.to(torch.float32)
                        + yi.to(torch.float32)).to(yi.dtype), x, y)


def tree_weighted_sum(trees_stacked: Tree, weights: torch.Tensor,
                      dtype=None) -> Tree:
    """sum_k w[k] * tree[k] for leaves with a leading K axis, in f32;
    `dtype` overrides the output leaf dtype (default: the leaf's)."""

    def leaf(x):
        w = weights.to(torch.float32).reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.sum(x.to(torch.float32) * w, dim=0).to(dtype or x.dtype)

    return tree_map(leaf, trees_stacked)


def tree_vdot_batched(stacked: Tree, single: Tree) -> torch.Tensor:
    """[<stacked[k], single> for k], leaves of `stacked` carry a K axis."""

    def leaf(x, y):
        dims = tuple(range(1, x.ndim))
        return torch.sum(x.to(torch.float32) * y.to(torch.float32)[None],
                         dim=dims)

    return functools.reduce(torch.add,
                            tree_leaves(tree_map(leaf, stacked, single)))


def tree_sqnorm_batched(stacked: Tree) -> torch.Tensor:
    """[||stacked[k]||^2 for k]."""

    def leaf(x):
        xf = x.to(torch.float32)
        return torch.sum(xf * xf, dim=tuple(range(1, x.ndim)))

    return functools.reduce(torch.add, tree_leaves(tree_map(leaf, stacked)))


# ---------------------------------------------------------------------------
# Flat-buffer view (the engine="flat" round path): one contiguous (K, N)
# f32 buffer per round, so the angle statistics and both aggregations
# stream through the CUDA kernels. The unflattener is cached on
# (treedef, shapes, dtypes).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cached_unravel(treedef, shapes, dtypes) -> Callable:
    sizes = [math.prod(s) for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def unravel(vec: torch.Tensor, dtype=None) -> Tree:
        """dtype overrides the recorded leaf dtypes (e.g. torch.float32
        to keep an f32 view for angle statistics)."""
        leaves = [
            vec[int(offsets[i]):int(offsets[i + 1])].reshape(shapes[i])
            .to(dtype or dtypes[i])
            for i in range(len(shapes))
        ]
        return tree_unflatten(treedef, leaves)

    return unravel


def tree_ravel(tree: Tree) -> tuple[torch.Tensor, Callable]:
    """(vec (N,) f32, unravel): unravel(vec) restores structure, shapes
    and leaf dtypes."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    vec = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])
    return vec, _cached_unravel(treedef, shapes, dtypes)


def tree_ravel_stacked(stacked: Tree,
                       sharding=None) -> tuple[torch.Tensor, Callable]:
    """Flatten a K-stacked tree (leaves (K, ...)) into a contiguous (K, N)
    f32 buffer. Returns (buf, unravel); unravel maps an (N,) vector back
    to ONE unstacked tree (leaf shapes without the K axis).

    `sharding` (a client mesh's row sharding,
    `core.fl_shard_map.flat_client_sharding`) ravels this rank's block
    of the K rows only, (K / mesh size, N); K must divide."""
    leaves, treedef = tree_flatten(stacked)
    if sharding is not None:
        rows = sharding.rows(leaves[0].shape[0])
        leaves = [l[rows] for l in leaves]
    k = leaves[0].shape[0]
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    buf = torch.cat([l.reshape(k, -1).to(torch.float32) for l in leaves],
                    dim=1)
    return buf, _cached_unravel(treedef, shapes, dtypes)


def unraveler(tree: Tree) -> Callable:
    """`tree_ravel(tree)`'s unravel, without raveling the tree."""
    leaves, treedef = tree_flatten(tree)
    return _cached_unravel(treedef, tuple(tuple(l.shape) for l in leaves),
                           tuple(l.dtype for l in leaves))


def tree_unravel_stacked(template: Tree, buf: torch.Tensor,
                         dtype=None) -> Tree:
    """Map a (K, N) buffer back to a K-stacked tree shaped like `template`
    (row k -> client k's leaves), the inverse of `tree_ravel_stacked`.
    `dtype` overrides the leaf dtype (default: the template's). The tree
    engine passes torch.float32 for the dequantized wire, so a bf16 leaf
    does not put a second rounding on what the flat engine reads."""
    leaves, treedef = tree_flatten(template)
    k = buf.shape[0]
    out, off = [], 0
    for l in leaves:
        size = math.prod(l.shape[1:])
        out.append(buf[:, off:off + size].reshape((k,) + tuple(l.shape[1:]))
                   .to(dtype or l.dtype))
        off += size
    return tree_unflatten(treedef, out)


def segment_mask(tree: Tree, keep: list) -> torch.Tensor:
    """(N,) f32 0/1 mask over the ravel order, on the tree's device: 1
    where the leaf is kept. `keep` is one bool per leaf (flatten order)."""
    leaves = tree_leaves(tree)
    assert len(leaves) == len(keep), "keep/tree flatten-order mismatch"
    parts = [np.full(l.numel(), 1.0 if k else 0.0, np.float32)
             for l, k in zip(leaves, keep)]
    return torch.from_numpy(np.concatenate(parts)).to(leaves[0].device)


def tree_leaves_like(template: Tree, tree: Tree) -> list:
    """`tree`'s values at `template`'s leaf positions, in flatten order:
    how a spec tree, whose leaves are tuples, is flattened along the
    param tree it describes."""
    if isinstance(template, dict):
        return [v for key in sorted(template)
                for v in tree_leaves_like(template[key], tree[key])]
    if isinstance(template, (list, tuple)):
        return [v for t, u in zip(template, tree)
                for v in tree_leaves_like(t, u)]
    return [tree]


# ---------------------------------------------------------------------------
# The 2D (client x model) blocked ravel: the flat engine on a mesh with a
# model axis. Each model shard ravels its LOCAL leaf blocks into one
# column block of the same width on every shard (leaf segments at the same
# offsets): a model-sharded leaf gives its local block, a replicated leaf
# is ceil-split into n_shards column slices (the last zero-padded). The
# padding is zero in the rows and in every aggregate, so it adds exactly
# zero to every dot and norm. The blocked order is a per-shard permutation
# of `tree_ravel_stacked`'s: the round's sums do not care, but the wire's
# quantization chunks and groups are SHARD-LOCAL (a scale never straddles
# a model-axis split) -- the wire layout of a 2D mesh.
# ---------------------------------------------------------------------------


class BlockedLayout(NamedTuple):
    """The per-shard column block of a stacked tree (hashable)."""

    n_shards: int
    width: int  # per-shard block width N_loc (sum of the leaf widths)
    n_logical: int  # unpadded element count (sum of the leaf sizes)
    shapes: tuple  # unstacked global leaf shapes
    dtypes: tuple  # leaf dtypes
    sharded_dims: tuple  # per leaf: its model-sharded dim, or -1
    widths: tuple  # per leaf: its segment width in a shard's block


def blocked_layout(stacked: Tree, pspecs: Tree, n_shards: int,
                   model_axis: str = "model") -> BlockedLayout:
    """The (client x model) block plan of a K-stacked delta tree.

    `stacked`: leaves (K, ...) (tensors, meta tensors too); `pspecs`:
    the UNSTACKED spec tree (`models.sharding.param_pspecs`: one tuple a
    leaf). A leaf whose spec puts `model_axis` on a dim is model-sharded
    there (the dim must divide by n_shards); every other leaf is
    replicated over the model axis and ceil-split column-wise."""
    leaves = tree_leaves(stacked)
    spec_leaves = tree_leaves_like(stacked, pspecs)
    assert len(leaves) == len(spec_leaves), "stacked/pspec leaf mismatch"
    shapes, dtypes, sharded_dims, widths = [], [], [], []
    for leaf, spec in zip(leaves, spec_leaves):
        shape = tuple(leaf.shape[1:])
        spec = tuple(spec or ())
        entries = spec + (None,) * (len(shape) - len(spec))
        sdim = -1
        for d, entry in enumerate(entries):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            if model_axis in names:
                if entry != model_axis:
                    raise ValueError(
                        f"leaf spec {spec} mixes {model_axis!r} with other "
                        "axes on one dim — unsupported by the blocked ravel")
                if sdim >= 0:
                    raise ValueError(
                        f"leaf spec {spec} shards {model_axis!r} twice")
                sdim = d
        size = math.prod(shape)
        if sdim >= 0:
            if shape[sdim] % n_shards:
                raise ValueError(
                    f"model-sharded dim {sdim} of shape {shape} not "
                    f"divisible by {n_shards}")
            w = size // n_shards
        else:
            w = -(-size // n_shards)  # ceil split, zero-padded last shard
        shapes.append(shape)
        dtypes.append(leaf.dtype)
        sharded_dims.append(sdim)
        widths.append(w)
    return BlockedLayout(
        n_shards=n_shards, width=sum(widths),
        n_logical=sum(math.prod(s) for s in shapes), shapes=tuple(shapes),
        dtypes=tuple(dtypes), sharded_dims=tuple(sharded_dims),
        widths=tuple(widths))


def blocked_ravel_local(stacked_local_leaves: list, layout: BlockedLayout,
                        shard_index: int) -> torch.Tensor:
    """Ravel model shard `shard_index`'s stacked leaf blocks into one
    contiguous (k_loc, width) f32 buffer: `stacked_local_leaves` are
    (k_loc, *local_shape) for a model-sharded leaf (its block) and
    (k_loc, *shape) for a replicated one, of which the shard takes its
    column slice. No collective."""
    parts = []
    for x, sdim, w in zip(stacked_local_leaves, layout.sharded_dims,
                          layout.widths):
        xf = x.reshape(x.shape[0], -1).to(torch.float32)
        if sdim < 0:  # the shard's column slice, zero-padded to w
            n = xf.shape[1]
            lo = min(shard_index * w, n)
            xf = xf[:, lo:min(lo + w, n)]
            if xf.shape[1] < w:
                xf = torch.nn.functional.pad(xf, (0, w - xf.shape[1]))
        elif xf.shape[1] != w:
            raise ValueError(f"a model-sharded leaf's block holds "
                             f"{xf.shape[1]} elements a row, want {w}")
        parts.append(xf)
    return torch.cat(parts, dim=1)


def blocked_split(arr: torch.Tensor, layout: BlockedLayout) -> list:
    """A blocked (..., width) tensor's per-leaf segments (views), the
    inverse of `blocked_ravel_local`'s concatenation."""
    out, off = [], 0
    for w in layout.widths:
        out.append(arr[..., off:off + w])
        off += w
    return out


def blocked_segment_mask(layout: BlockedLayout, keep=None) -> torch.Tensor:
    """(width,) f32 0/1 mask over the blocked order, on the CPU; the same
    on every shard (leaf segments sit at the same offsets). `keep` is
    one bool a leaf (None: all ones). A replicated leaf's zero padding
    keeps its leaf's value: padded positions are zero in the rows and
    the aggregate, so they add nothing whatever the mask."""
    if keep is None:
        keep = [True] * len(layout.widths)
    assert len(keep) == len(layout.widths), "keep/layout leaf mismatch"
    return torch.from_numpy(np.concatenate(
        [np.full(w, 1.0 if k else 0.0, np.float32)
         for w, k in zip(layout.widths, keep)]))
