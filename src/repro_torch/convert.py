"""Carry weights and round state across from numpy.

The port keeps the JAX package's param layout (HWIO convs, (in, out)
dense weights), so moving a model between the two packages is a plain
copy of each array. The tests start both packages from the same numpy
state with these.
"""
from __future__ import annotations

import numpy as np
import torch

import repro_torch
from repro_torch.core import fl as fl_mod
from repro_torch.core import treemath
from repro_torch.core.weighting import AngleState


def _device(device) -> torch.device:
    return repro_torch.default_device() if device is None else \
        torch.device(device)


def params_from_numpy(tree, device=None):
    """A (nested) dict of numpy arrays -> the same tree of tensors on
    `device` (CUDA when None), dtypes kept."""
    dev = _device(device)
    return treemath.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(params):
    """A tree of tensors -> the same tree of numpy arrays."""
    return treemath.tree_map(lambda t: t.detach().cpu().numpy(), params)


def round_state_from_numpy(fl: fl_mod.FLConfig, params, angle_smoothed,
                           angle_count, round: int = 0, device=None,
                           ef=None) -> fl_mod.RoundState:
    """A RoundState from numpy params and Eq. 9 angle state (smoothed
    (num_clients,) f32, count (num_clients,) int), at round `round`.
    `ef`, a (num_clients, N) array, replaces the uplink error-feedback
    residual (zeros when None and `fl.error_feedback` is set)."""
    dev = _device(device)
    state = fl_mod.init_round_state(fl, params_from_numpy(params, dev))
    angle = AngleState(
        smoothed=torch.tensor(np.asarray(angle_smoothed, np.float32),
                              device=dev),
        count=torch.tensor(np.asarray(angle_count, np.int32), device=dev))
    state = state._replace(angle=angle, round=int(round))
    if ef is not None:
        if state.ef is None:
            raise ValueError("ef given but fl.error_feedback is not set")
        ef = torch.tensor(np.asarray(ef, np.float32), device=dev)
        if ef.shape != state.ef.shape:
            raise ValueError(f"ef must be {tuple(state.ef.shape)}, got "
                             f"{tuple(ef.shape)}")
        state = state._replace(ef=ef)
    return state
