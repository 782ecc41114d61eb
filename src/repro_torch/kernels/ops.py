"""Tree-level wrappers over the port's kernels: the counterpart of
`repro/kernels/ops.py`. Trees are walked leaf by leaf (in sorted-key
order, as `jax.tree_util` flattens them) and the per-leaf results are
combined, so no concatenated copy of the parameter vector is made. On
CUDA tensors every leaf goes through its kernel; on CPU tensors through
the kernel's plain version.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import treemath
from repro_torch.kernels import grad_dot, weighted_agg

Tree = Any


def tree_dot_and_norms(a: Tree, b: Tree):
    """(<a,b>, ||a||^2, ||b||^2) over all leaves, f32 scalars."""
    dots, nas, nbs = [], [], []
    for x, y in zip(treemath.tree_leaves(a), treemath.tree_leaves(b)):
        d, na, nb = grad_dot.grad_dot_stats(x, y)
        dots.append(d)
        nas.append(na)
        nbs.append(nb)
    return (torch.sum(torch.stack(dots)), torch.sum(torch.stack(nas)),
            torch.sum(torch.stack(nbs)))


def tree_weighted_sum(stacked: Tree, w: torch.Tensor) -> Tree:
    """sum_k w[k] * tree[k] for leaves with a leading K axis, in each
    leaf's dtype."""

    def leaf(x):
        k = x.shape[0]
        y = weighted_agg.weighted_agg(w, x.reshape(k, -1).contiguous(),
                                      out_dtype=torch.float32)
        return y.reshape(x.shape[1:]).to(x.dtype)

    return treemath.tree_map(leaf, stacked)


def tree_vdot_batched(stacked: Tree, single: Tree) -> torch.Tensor:
    """u[k] = sum over leaves of <stacked[k], single>, (K,) f32."""
    parts = []
    for x, g in zip(treemath.tree_leaves(stacked),
                    treemath.tree_leaves(single)):
        parts.append(weighted_agg.batched_dot(x.reshape(x.shape[0], -1),
                                              g.reshape(-1)))
    return torch.sum(torch.stack(parts), dim=0)
