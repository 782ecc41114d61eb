"""Mamba-1 selective SSM block (arXiv:2312.00752), as used by Jamba
(arXiv:2403.19887): the counterpart of `repro/models/mamba.py`.

The selective scan keeps Mamba-1's full (d_inner x d_state)
data-dependent decay, so it advances one step at a time: a Python loop
over T with the state in f32 (the reference scans). `ssm.scan_unroll`,
the number of steps the reference runs in one scan iteration, changes no
number and no order of operations, so the loop is the same for every
value. `ssm.stream_dtype` is honoured: the x, B and C streams are stored
in it and read back to f32 in the step; dt stays f32.

The depthwise causal conv is the reference's `WIO` (K, 1, di)
cross-correlation, run as `F.conv1d(groups=di)` on weights (di, 1, K)
over the decode prefix buffer (K-1 positions) and the input.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def d_inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def mamba_init(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = d_inner(cfg)
    dtr = _dt_rank(cfg)
    dt = cfg.tdtype
    f32 = torch.float32
    # S4D-real initialization for A
    A = np.tile(np.arange(1, s.d_state + 1, dtype=np.float32), (di, 1))
    return {
        "in_proj": layers.dense_init(d, 2 * di, dt),
        "conv_w": layers.normal((s.d_conv, 1, di), 0.1, dt),
        "conv_b": layers.full((di,), 0.0, dt),
        "x_proj": layers.dense_init(di, dtr + 2 * s.d_state, dt),
        "dt_w": layers.dense_init(dtr, di, dt),
        # softplus^-1(0.01)
        "dt_b": layers.full((di,), np.float32(np.log(np.expm1(0.01))), f32),
        "A_log": layers.full((di, s.d_state), np.log(A), f32),
        "D": layers.full((di,), 1.0, f32),
        "out_proj": layers.dense_init(di, d, dt),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 buf=None):
    """Depthwise causal conv. x (B,T,di); w (K,1,di). buf (B,K-1,di)
    decode prefix or None (zero history). Returns (y, new_buf)."""
    K = w.shape[0]
    prefix = (x.new_zeros((x.shape[0], K - 1, x.shape[2])) if buf is None
              else buf)
    xp = torch.cat([prefix, x], dim=1)
    y = F.conv1d(xp.transpose(1, 2), w.permute(2, 1, 0),
                 groups=x.shape[2]).transpose(1, 2)
    return y + b, xp[:, -(K - 1):]


def _ssm_params(p, cfg, x_c):
    """x_c (B,T,di) -> dt (B,T,di), Bm/Cm (B,T,n) in f32."""
    s = cfg.ssm
    dtr = _dt_rank(cfg)
    proj = (x_c @ p["x_proj"]).to(torch.float32)
    dt_in, Bm, Cm = torch.split(proj, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt_in @ p["dt_w"].to(torch.float32) + p["dt_b"])
    return dt, Bm, Cm


def mamba_forward(p: dict, cfg, x: torch.Tensor, state: dict | None):
    """x (B,T,d). state: None or {"h": (B,di,n), "conv": (B,K-1,di)}.

    Returns (y (B,T,d), new_state)."""
    f32 = torch.float32
    di = d_inner(cfg)
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    buf = None if state is None else state["conv"]
    x_c, new_buf = _conv_causal(x_in, p["conv_w"], p["conv_b"], buf)
    x_c = F.silu(x_c)

    dt, Bm, Cm = _ssm_params(p, cfg, x_c)
    A = -torch.exp(p["A_log"])  # (di, n)
    h = (x.new_zeros((x.shape[0], di, cfg.ssm.d_state), dtype=f32)
         if state is None else state["h"].to(f32))
    # the x / B / C streams are stored in the stream dtype; dt stays f32
    sdt = getattr(torch, cfg.ssm.stream_dtype)
    xcf, Bm, Cm = (t.to(sdt) for t in (x_c.to(f32), Bm, Cm))
    ys = []
    for i in range(x.shape[1]):
        x_t, dt_t = xcf[:, i].to(f32), dt[:, i]
        B_t, C_t = Bm[:, i].to(f32), Cm[:, i].to(f32)
        decay = torch.exp(dt_t[..., None] * A[None])  # (B,di,n)
        h = decay * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_t))
    y = torch.stack(ys, dim=1) + p["D"] * xcf  # (B,T,di)
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y, {"h": h, "conv": new_buf}


def init_state(cfg, b: int, device=None) -> dict:
    di = d_inner(cfg)
    return {
        "h": torch.zeros((b, di, cfg.ssm.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((b, cfg.ssm.d_conv - 1, di), dtype=cfg.tdtype,
                            device=device),
    }
