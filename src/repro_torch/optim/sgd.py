"""Minimal functional optimizers on tensor trees: the counterpart of
`repro/optim/sgd.py`.

An optimizer is (init_fn, update_fn):
  state = init(params)
  new_params, new_state = update(params, grads, state, lr)

Params and grads are (nested) dicts of tensors. The math is f32 whatever
the params' dtype, and each new param is cast back to its param's dtype;
moment buffers are f32, and adam's step count `t` is an int32 tensor on
the params' device, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import treemath

Tree = Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _zeros(params: Tree) -> Tree:
    return treemath.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(params, grads, state, lr):
        new = treemath.tree_map(
            lambda p, g: (_f32(p) - lr * _f32(g)).to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(params, grads, state, lr):
        vel = treemath.tree_map(lambda v, g: beta * v + _f32(g), state, grads)
        new = treemath.tree_map(
            lambda p, v: (_f32(p) - lr * v).to(p.dtype), params, vel)
        return new, vel

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        device = treemath.tree_leaves(params)[0].device
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(params, grads, state, lr):
        t = state["t"] + 1
        m = treemath.tree_map(lambda m, g: b1 * m + (1 - b1) * _f32(g),
                              state["m"], grads)
        v = treemath.tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(_f32(g)),
            state["v"], grads)
        bc1 = 1 - b1 ** _f32(t)
        bc2 = 1 - b2 ** _f32(t)
        new = treemath.tree_map(
            lambda p, mm, vv: (
                _f32(p) - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            ).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def exponential_decay(base_lr: float, rate: float) -> Callable:
    """Paper's schedule: lr * rate^round (0.995 per communication round),
    an f32 scalar tensor."""

    def schedule(round_idx):
        return base_lr * rate ** torch.as_tensor(round_idx,
                                                 dtype=torch.float32)

    return schedule


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam}
