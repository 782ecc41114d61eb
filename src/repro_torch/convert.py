"""Carry weights and round state across from numpy.

The port keeps the JAX package's param layout (HWIO convs, (in, out)
dense weights, (vocab, d) embeddings, LM block params stacked over
groups), so moving a model between the two packages is a plain copy of
each array. bfloat16 arrays (numpy's `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses) are carried bit for bit through their 16-bit
patterns. The tests start both packages from the same numpy state with
these.
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


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device=None):
    """A (nested) dict of numpy arrays -> the same tree of tensors on
    `device` (CUDA when None), dtypes kept (bfloat16 bit for bit)."""
    dev = _device(device)
    return treemath.tree_map(lambda a: _tensor(a).to(dev), tree)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only for bf16 leaves

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params):
    """A tree of tensors -> the same tree of numpy arrays (bfloat16 as
    `ml_dtypes.bfloat16`, bit for bit)."""
    return treemath.tree_map(_array, params)


def lm_params_from_numpy(tree, cfg, device=None):
    """The LM params of `cfg` from a numpy tree in the JAX package's
    layout (`repro.models.transformer.init_params`), on `device` (CUDA
    when None). Every leaf's path, shape and dtype must be those of the
    port's `init_params` for `cfg`; a mismatch raises ValueError naming
    the leaf."""
    from repro_torch.models import transformer

    want = transformer.init_params(None, cfg, device="meta")
    got_paths, want_paths = (treemath.tree_paths(tree),
                             treemath.tree_paths(want))
    if got_paths != want_paths:
        raise ValueError(f"{cfg.name}: param tree paths differ: got "
                         f"{sorted(set(got_paths) ^ set(want_paths))[:8]} "
                         "on one side only")
    params = params_from_numpy(tree, device)
    for path, t, w in zip(want_paths, treemath.tree_leaves(params),
                          treemath.tree_leaves(want)):
        if t.shape != w.shape or t.dtype != w.dtype:
            raise ValueError(
                f"{cfg.name}: param {'/'.join(map(str, path))} is "
                f"{tuple(t.shape)} {t.dtype}, want {tuple(w.shape)} "
                f"{w.dtype}")
    return params


def _fields(x) -> dict:
    """A NamedTuple (the JAX package's or the port's) or a mapping as a
    dict of numpy arrays."""
    d = x._asdict() if hasattr(x, "_asdict") else dict(x)
    return {k: np.asarray(v) for k, v in d.items()}


def _like(name: str, value, want: torch.Tensor) -> torch.Tensor:
    """`value` as a tensor of `want`'s dtype on its device; ValueError
    when the shapes differ."""
    t = torch.as_tensor(np.array(value)).to(want.device, want.dtype)
    if t.shape != want.shape:
        raise ValueError(f"{name} must be {tuple(want.shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def round_state_from_numpy(fl: fl_mod.FLConfig, params, angle_smoothed,
                           angle_count, round: int = 0, device=None,
                           ef=None, dl_ef=None, bcast=None, buf=None,
                           prev_delta=None) -> fl_mod.RoundState:
    """A RoundState from numpy params and Eq. 9 angle state (smoothed
    (num_clients,) f32, count (num_clients,) int), at round `round`.

    Each optional field replaces the fresh state's, and must be one the
    config allocates (ValueError otherwise, or on a shape mismatch): `ef`
    the (num_clients, N) uplink residual, `dl_ef` the (N,) downlink
    residual, `bcast` the broadcast state and `buf` the report buffer
    (each a NamedTuple of either package or a mapping of its fields), and
    `prev_delta` a tree shaped like `params`."""
    dev = _device(device)
    state = fl_mod.init_round_state(fl, params_from_numpy(params, dev))
    angle = AngleState(
        smoothed=torch.tensor(np.asarray(angle_smoothed, np.float32),
                              device=dev),
        count=torch.tensor(np.asarray(angle_count, np.int32), device=dev))
    state = state._replace(angle=angle, round=int(round))
    for name, flag, value in (
            ("ef", "error_feedback", ef),
            ("dl_ef", "downlink_error_feedback", dl_ef),
            ("bcast", "downlink_delta", bcast),
            ("buf", "aggregation='buffered'", buf)):
        if value is None:
            continue
        have = getattr(state, name)
        if have is None:
            raise ValueError(f"{name} given but the config does not set "
                             f"{flag}")
        if isinstance(have, torch.Tensor):
            new = _like(name, value, have)
        else:
            got = _fields(value)
            new = type(have)(**{
                k: _like(f"{name}.{k}", got[k], getattr(have, k))
                for k in have._fields})
        state = state._replace(**{name: new})
    if prev_delta is not None:
        state = state._replace(prev_delta=treemath.tree_map(
            lambda v, p: _like("prev_delta", v, p), prev_delta,
            state.prev_delta))
    return state


def round_state_to_numpy(state: fl_mod.RoundState) -> dict:
    """The inverse of `round_state_from_numpy`: a dict of its arguments
    (params, angle_smoothed, angle_count, round, ef, dl_ef, bcast, buf,
    prev_delta) as numpy, None for the fields the config leaves out;
    `bcast` and `buf` as dicts of their fields."""
    def tup(x):
        return None if x is None else {k: _array(v) for k, v in
                                       x._asdict().items()}

    return {
        "params": params_to_numpy(state.params),
        "angle_smoothed": _array(state.angle.smoothed),
        "angle_count": _array(state.angle.count),
        "round": int(state.round),
        "ef": None if state.ef is None else _array(state.ef),
        "dl_ef": None if state.dl_ef is None else _array(state.dl_ef),
        "bcast": tup(state.bcast), "buf": tup(state.buf),
        "prev_delta": params_to_numpy(state.prev_delta),
    }
