"""Training recompute: the port's counterpart of `jax.checkpoint`.

`recompute(fn, *args)` returns `fn(*args)` (a tuple of tensors) and keeps
only `args` for the backward, which runs `fn` again through
`torch.func.vjp` and returns the cotangents. The model applies it where
the reference applies `jax.checkpoint`: to each group of blocks in
`transformer.forward(..., mode="train")` (so the backward keeps one
residual stream a group, not every layer's activations) and to each
chunk of `transformer._chunked_ce` (so a chunk's (B, L, V) logits are
not kept). `torch.utils.checkpoint` refuses to run under
`torch.func.grad`; this Function runs under `torch.func.grad`,
`torch.func.vmap` (its `vmap` rule recomputes the vmapped `fn`) and
plain autograd, on every device including "meta".

Every tensor `fn` reads must be one of `args`: a tensor it closes over
would enter the recompute from the wrong functorch level. Integer
arguments (labels) get no cotangent. Under tensor-parallel execution
(`models/tp.py`) `fn` runs collectives: the backward's rerun and its
vjp run them again, in the same order on every rank of the model group,
since every rank runs the same program on its own blocks.

One output is kept rather than recomputed: a flash-attention kernel's
(`kernels/flash_attn.py`), a selective checkpoint policy like
`jax.checkpoint_policies.save_only_these_names`. Each `recompute` call
carries a `Tape`; while its first run of `fn` is active, `saved(make)`
records what `make()` returns, and the backward's run reads the same
outputs back in order instead of launching the kernel again. The tape
holds the kernel's (B, T, H, hd) output a layer until the backward.
"""
from __future__ import annotations

from typing import Callable

import torch

_ACTIVE: list = []  # the tapes of the recompute runs in progress


class Tape:
    """The saved outputs of one recompute call's kernels."""

    def __init__(self):
        self.outputs: list = []
        self.cursor = 0
        self.recorded = False  # True once the first run has finished


def saved(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """`make()`, recorded on the active tape during a recompute call's
    first run and read back from it on every later run; outside a
    recompute, just `make()`."""
    if not _ACTIVE:
        return make()
    tape = _ACTIVE[-1]
    if not tape.recorded:
        out = make()
        tape.outputs.append(out)
        return out
    if tape.cursor >= len(tape.outputs):
        raise RuntimeError("recompute: the backward's run of the function "
                           "saved more outputs than its first run")
    out = tape.outputs[tape.cursor]
    tape.cursor += 1
    return out.detach()


def _taped(fn: Callable, tape: Tape) -> Callable:
    def run(*args):
        tape.cursor = 0
        _ACTIVE.append(tape)
        try:
            out = fn(*args)
        finally:
            _ACTIVE.pop()
        tape.recorded = True
        return out

    return run


class _Recompute(torch.autograd.Function):
    """forward: `fn(*args)`, its graph dropped and only the inputs kept;
    backward: `fn` again through `torch.func.vjp`. The `vmap` rule
    applies the Function to `torch.func.vmap(fn)` on the unbatched
    arguments."""

    generate_vmap_rule = False

    @staticmethod
    def forward(fn, *args):
        # run as the backward's rerun and plain autograd run: with the
        # inputs requiring grad, since some ops pick their kernels by it
        # (matmul folds a 3-D input only when it needs no grad), so the
        # values are bit for bit theirs; the graph dies with the detach
        tracked = [a.detach().requires_grad_() if a.is_floating_point()
                   else a for a in args]
        with torch.enable_grad():
            out = fn(*tracked)
        # an input handed back as it is (an aux sum no block added to)
        # leaves as a view of itself, which setup_context may save
        ids = [id(t) for t in tracked]
        return tuple(args[ids.index(id(o))].view_as(o) if id(o) in ids
                     else o.detach() for o in out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        # torch.func's grad differentiates with create_graph=True, which
        # would record this rerun into the outer graph and keep its
        # activations to the end: the rerun starts from detached inputs.
        # Grad mode stays on, as in the forward (some ops pick their
        # kernels by it), so the gradients are plain autograd's bits.
        args = [a.detach() for a in ctx.saved_tensors]
        diff = [i for i, a in enumerate(args) if a.is_floating_point()]

        def f(*primals):
            full = list(args)
            for i, p in zip(diff, primals):
                full[i] = p
            return tuple(ctx.fn(*full))

        with torch.enable_grad():
            _, pull = torch.func.vjp(f, *(args[i] for i in diff))
            grads = pull(tuple(c.detach() for c in cotangents))
        out = [None] * len(args)
        for i, g in zip(diff, grads):
            out[i] = g
        return (None, *out)

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        batched = torch.func.vmap(fn, in_dims=tuple(in_dims[1:]),
                                  randomness=info.randomness)
        out = _Recompute.apply(batched, *args)
        return out, (0,) * len(out)


def recompute(fn: Callable, *args: torch.Tensor) -> tuple:
    """`fn(*args)` (a tuple of tensors), with only `args` kept for the
    backward, which recomputes `fn` (module docstring)."""
    return _Recompute.apply(_taped(fn, Tape()), *args)
