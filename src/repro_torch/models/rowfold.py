"""The `vmap` rule of the recurrent blocks' custom ops (`mamba.py`'s
selective scan, `rwkv6.py`'s chunked WKV): the vmapped dim folded into
the op's batch rows, so that the K clients of `torch.func.vmap(grad(
loss))` make one call of the op, not K.

Each op takes two kinds of tensor: "rows", whose dim 0 is the batch
rows (independent of each other), and "shared" parameters (the Mamba
`A`, the RWKV bonus `u`) of `base` dims, which the op also takes with
a leading rows dim: one per row. A shared parameter the vmap batches
(each client's own) folds into such a per-row parameter; in a forward
op one it does not batch stays shared. A backward op returns each
shared parameter's gradient in the layout it was given, and every
vmapped index needs its own gradient (its cotangents are its own),
so a backward's fold gives it every shared parameter per row
(`per_row_shared`), and `unfold_grad` sums each index's rows.
"""
from __future__ import annotations

import torch


def _rows(t: torch.Tensor, bdim, v: int) -> torch.Tensor:
    """(V, R, ...) of a rows tensor with its vmapped dim `bdim` (None:
    the same rows for every vmapped index)."""
    return t.movedim(bdim, 0) if bdim is not None else t.expand(v, *t.shape)


class Fold:
    """The folded arguments of one op call under `vmap`, and how each
    shared parameter was folded."""

    def __init__(self, info, in_dims, args, kinds, bases,
                 per_row_shared: bool = False):
        self.v = info.batch_size
        self.r = None
        for t, b, kind in zip(args, in_dims, kinds):
            if kind == "rows":
                self.r = _rows(t, b, self.v).shape[1]
                break
        self.args = []
        self.per_row = []  # per shared arg: whether given one per row
        for t, b, kind, base in zip(args, in_dims, kinds, bases):
            if kind == "rows":
                z = _rows(t, b, self.v)
                self.args.append(z.reshape(self.v * self.r, *z.shape[2:]))
                continue
            own = t.dim() - (b is not None) > base  # one per row already
            self.per_row.append(own)
            if b is None and not own and not per_row_shared:
                self.args.append(t)  # shared by every row of every index
                continue
            z = _rows(t, b, self.v)  # (V, [R,] ...)
            if not own:
                z = z[:, None].expand(self.v, self.r, *z.shape[1:])
            self.args.append(z.reshape(self.v * self.r, *z.shape[2:]))

    def unfold(self, out: torch.Tensor):
        """(V, R, ...) of a rows output of the folded call, vmapped at 0."""
        return out.reshape(self.v, self.r, *out.shape[1:]), 0

    def unfold_grad(self, g: torch.Tensor, i: int):
        """The gradient of the i-th shared parameter for each vmapped
        index, in the layout it was given (vmapped at 0), from a folded
        call that took it per row."""
        g = g.reshape(self.v, self.r, *g.shape[1:])
        return (g if self.per_row[i] else g.sum(1)), 0
