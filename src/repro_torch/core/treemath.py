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
from typing import Any, Callable

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
    it = iter(leaves)

    def build(d):
        if d is _LEAF:
            return next(it)
        kind, keys, defs = d
        children = [build(c) for c in defs]
        if kind == "dict":
            return dict(zip(keys, children))
        return list(children) if kind == "list" else tuple(children)

    return build(treedef)


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


def tree_sqnorm(a: Tree) -> torch.Tensor:
    """||a||^2 over all leaves, accumulated in f32."""
    return torch.sum(torch.stack([_fdot(x, x) for x in tree_leaves(a)]))


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
