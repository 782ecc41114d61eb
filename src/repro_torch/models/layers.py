"""Common neural-net building blocks, functional torch: the counterpart
of `repro/models/layers.py` for the dense LM stack.

Conventions (the reference's):
  * params are nested dicts of tensors; dense weights are (d_in, d_out),
    the embedding (vocab, d);
  * init functions draw from an explicit `torch.Generator` (or from none
    on the "meta" device, which allocates nothing) and return a subtree;
  * apply functions are pure: (params, x, ...) -> y;
  * compute dtype follows the input; norm statistics in f32.

Where torch's defaults differ from jax's, the reference's semantics are
kept: GELU is the tanh approximation (`jax.nn.gelu`'s default), the
LayerNorm variance is the population variance, the norm epsilon 1e-6
sits inside the rsqrt, and RoPE rotates the split halves of the head
with frequencies computed in float64 numpy and cast to f32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    scale = 1.0 / np.sqrt(d_in)
    return (_normal(gen, (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


# ----------------------------------------------------------------- norms


def norm_init(d: int, kind: str, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def norm_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------- MLPs


def mlp_init(gen, d: int, d_ff: int, kind: str, dtype, device) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, d_ff, dtype, device),
            "w_up": dense_init(gen, d, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d, dtype, device),
        }
    if kind in ("gelu", "relu_sq"):
        return {
            "w_up": dense_init(gen, d, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d, dtype, device),
        }
    raise ValueError(kind)


def mlp_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    elif kind == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    elif kind == "relu_sq":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:
        raise ValueError(kind)
    return h @ p["w_down"]


# ----------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., T) int -> cos/sin (..., T, head_dim//2) f32."""
    freqs = torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32))
    ang = positions.to(torch.float32)[..., None] * freqs.to(positions.device)
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd); cos/sin (B, T, hd//2) or (T, hd//2)."""
    xf = x.to(torch.float32)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


# ----------------------------------------------------------------- loss


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token cross-entropy, f32. logits (..., V), labels (...) int.

    The label pick is the reference's select + reduce (a masked sum over
    the vocab), not a gather; with `mask` the mean is weighted by it over
    max(sum(mask), 1)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], dtype=labels.dtype,
                        device=logits.device)
    picked = torch.where(iota == labels[..., None], logits,
                         torch.zeros((), dtype=torch.float32,
                                     device=logits.device))
    nll = logz - torch.sum(picked, dim=-1)
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
