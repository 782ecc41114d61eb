"""Common neural-net building blocks, functional torch: the counterpart
of `repro/models/layers.py`.

Conventions (the reference's, but for the init functions, which take
no PRNG key):
  * params are nested dicts of tensors; dense weights are (d_in, d_out),
    the embedding (vocab, d);
  * init functions return a subtree of `Init`s (shape, dtype and how
    to fill it); `make` turns one into tensors, drawing from an explicit
    `torch.Generator` (or from none on the "meta" device, which
    allocates nothing);
  * apply functions are pure: (params, x, ...) -> y;
  * compute dtype follows the input; norm statistics in f32.

Where torch's defaults differ from jax's, the reference's semantics are
kept: GELU is the tanh approximation (`jax.nn.gelu`'s default), the
LayerNorm variance is the population variance, the norm epsilon 1e-6
sits inside the rsqrt, and RoPE rotates the split halves of the head
with frequencies computed in float64 numpy and cast to f32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import tp


class Init(NamedTuple):
    """A param leaf still to be made: its shape and dtype, and
    `fill(gen, out)`, which writes its values into `out`, a tensor of
    that shape and dtype. The init functions return trees of these;
    `make` allocates each leaf once, in its dtype, and fills it."""
    shape: tuple
    dtype: torch.dtype
    fill: Callable[[Optional[torch.Generator], torch.Tensor], None]


# f32 elements drawn at once (256 MiB): a leaf is drawn in slices of
# whole rows of at most this many, so a draw's transient stays below it
_DRAW_ELEMS = 1 << 26


def _fill_normal(gen, out: torch.Tensor, scale: float) -> None:
    """out <- N(0, 1) * scale, drawn in f32, scaled, then cast to out's
    dtype, as the reference does."""
    flat = out.view(out.shape[0], -1)
    step = max(1, _DRAW_ELEMS // flat.shape[1])
    for i in range(0, flat.shape[0], step):
        rows = flat[i:i + step]
        # one expression: the draw is freed before the next one is made
        rows.copy_(torch.randn(rows.shape, generator=gen,
                               dtype=torch.float32,
                               device=out.device).mul_(scale))


def normal(shape, scale: float, dtype) -> Init:
    return Init(tuple(shape), dtype,
                lambda gen, out: _fill_normal(gen, out, scale))


def uniform(shape, dtype) -> Init:
    """U[0, 1) drawn in f32, then cast."""
    def fill(gen, out):
        out.copy_(torch.rand(out.shape, generator=gen, dtype=torch.float32,
                             device=out.device))

    return Init(tuple(shape), dtype, fill)


def full(shape, value, dtype) -> Init:
    """A constant: a scalar, or an array broadcast to `shape`."""
    def fill(gen, out):
        out.copy_(torch.as_tensor(value))

    return Init(tuple(shape), dtype, fill)


def stacked(n: int, tree):
    """Every leaf of `tree` with a leading axis of n, filled slice by
    slice (the reference vmaps the init over n keys)."""
    if isinstance(tree, dict):
        return {k: stacked(n, v) for k, v in tree.items()}

    def fill(gen, out):
        for i in range(n):
            tree.fill(gen, out[i])

    return Init((n,) + tree.shape, tree.dtype, fill)


def make(tree, gen: Optional[torch.Generator], device):
    """The tensors of a tree of `Init`s on `device`: each leaf allocated
    once and filled in place from `gen`, so that the only transient is
    one draw. On the "meta" device nothing is allocated or drawn."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: make(v, gen, device) for k, v in tree.items()}
    out = torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if device.type != "meta":
        tree.fill(gen, out)
    return out


def dense_init(d_in: int, d_out: int, dtype) -> Init:
    return normal((d_in, d_out), 1.0 / np.sqrt(d_in), dtype)


def embed_init(vocab: int, d: int, dtype) -> Init:
    return normal((vocab, d), 0.02, dtype)


# ----------------------------------------------------------------- norms


def norm_init(d: int, kind: str, dtype) -> dict:
    if kind == "rmsnorm":
        return {"scale": full((d,), 1.0, dtype)}
    if kind == "layernorm":
        return {"scale": full((d,), 1.0, dtype),
                "bias": full((d,), 0.0, dtype)}
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


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm within each head: x (..., H, hd), in f32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------- MLPs


def mlp_init(d: int, d_ff: int, kind: str, dtype) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(d, d_ff, dtype),
            "w_up": dense_init(d, d_ff, dtype),
            "w_down": dense_init(d_ff, d, dtype),
        }
    if kind in ("gelu", "relu_sq"):
        return {
            "w_up": dense_init(d, d_ff, dtype),
            "w_down": dense_init(d_ff, d, dtype),
        }
    raise ValueError(kind)


def mlp_apply(p: dict, x: torch.Tensor, kind: str,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The FFN. Given the config's `d_ff`, leaves that hold a block of
    it (inside a `tp.scope`) run tensor-parallel: `w_gate` / `w_up`
    column-parallel, `w_down` row-parallel, its partial product summed
    over "model"."""
    sharded = d_ff is not None and tp.split(p["w_up"].shape[-1], d_ff) > 1
    if sharded:
        x = tp.copy_to_model(x)
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
    y = h @ p["w_down"]
    return tp.reduce_from_model(y) if sharded else y


# ----------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., T) int -> cos/sin (..., T, head_dim//2) f32."""
    freqs = torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32))
    ang = positions.to(torch.float32)[..., None] * freqs.to(positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections):
    """Qwen2-VL multimodal RoPE [arXiv:2409.12191]: positions (3, B, T),
    the temporal / height / width streams; `sections` splits head_dim//2
    among them. Returns cos/sin (B, T, head_dim//2)."""
    assert positions.shape[0] == 3
    cos3, sin3 = rope_cos_sin(positions, head_dim, theta)  # (3,B,T,hd/2)
    cuts = np.cumsum(np.asarray(sections))[:-1].tolist()
    cos_parts = torch.tensor_split(cos3, cuts, dim=-1)
    sin_parts = torch.tensor_split(sin3, cuts, dim=-1)
    return (torch.cat([cos_parts[i][i] for i in range(3)], dim=-1),
            torch.cat([sin_parts[i][i] for i in range(3)], dim=-1))


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


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              vocab_start: Optional[int] = None) -> torch.Tensor:
    """Each token's -log p(label), f32: logits (..., V), labels (...).

    The label pick is the reference's select + reduce (a masked sum over
    the vocab), not a gather. With `vocab_start` the logits are this
    rank's vocab block from that id (inside a `tp.scope`): the log-sum-exp
    takes the detached max over "model", then sums the shifted exps over
    it, and the pick is summed over it (each label lies in one block)."""
    logits = logits.to(torch.float32)
    start = 0 if vocab_start is None else vocab_start
    iota = torch.arange(start, start + logits.shape[-1], dtype=labels.dtype,
                        device=logits.device)
    picked = torch.sum(torch.where(iota == labels[..., None], logits,
                                   torch.zeros((), dtype=torch.float32,
                                               device=logits.device)),
                       dim=-1)
    if vocab_start is None:
        return torch.logsumexp(logits, dim=-1) - picked
    top = tp.max_over_model(torch.amax(logits, dim=-1))
    sumexp = tp.reduce_from_model(
        torch.sum(torch.exp(logits - top[..., None]), dim=-1))
    return top + torch.log(sumexp) - tp.reduce_from_model(picked)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          vocab_start: Optional[int] = None
                          ) -> torch.Tensor:
    """Mean token cross-entropy, f32. logits (..., V), labels (...) int
    (`token_nll`; `vocab_start` for vocab-parallel logits). With `mask`
    the mean is weighted by it over max(sum(mask), 1)."""
    nll = token_nll(logits, labels, vocab_start)
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
