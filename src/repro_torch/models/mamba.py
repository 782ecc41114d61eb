"""Mamba-1 selective SSM block (arXiv:2312.00752), as used by Jamba
(arXiv:2403.19887): the counterpart of `repro/models/mamba.py`.

The selective scan keeps Mamba-1's full (d_inner x d_state)
data-dependent decay, so it advances one step at a time. It is one
custom op, `repro_torch::selective_scan` (the reference's `lax.scan` is
one op as well): a loop over T with the state in f32, on every device,
with a fake (meta) kernel, a `vmap` rule that folds the vmapped dim
into the batch rows (`rowfold`), and a backward that is one op of its
own, `repro_torch::selective_scan_backward`. The backward keeps no
step's state from the forward: it reruns the recurrence from the
inputs, keeping the state at the start of every chunk of ceil(sqrt(T))
steps, then walks the chunks backwards, each rerun from its start, so
that it holds about 2 sqrt(T) states (`scan_workspace`), where the
loop's autograd kept all T. Its gradients are the loop's autograd's
up to the order of the f32 sums. Training reaches the op through
`_Scan`, an autograd Function with a generated `vmap` rule, since
`torch.func.grad` does not run a custom op's own autograd.
`ssm.scan_unroll`, the number of steps the reference runs in one scan
iteration, changes no number and no order of operations, so the op is
the same for every value. `ssm.stream_dtype` is honoured: the x, B and
C streams are stored in it and read back to f32 in the step; dt stays
f32.

The depthwise causal conv is the reference's `WIO` (K, 1, di)
cross-correlation, run as `F.conv1d(groups=di)` on weights (di, 1, K)
over the decode prefix buffer (K-1 positions) and the input.

Inside a `tp.scope` a rank runs the d_inner channels of its blocks
(`conv_w`, `dt_w`, `A_log`, `x_proj`'s and `out_proj`'s rows, the
cache's `h` and `conv`): the conv and the scan are local, the
replicated `conv_b`, `dt_b` and `D` are narrowed to the rank's
channels. `in_proj`'s blocks are contiguous column blocks of (d, 2 di)
as the reference's rules cut it, which do not follow the channel
blocks (on two ranks rank 0 holds every x column, rank 1 every z
column), so its output is all-gathered over "model" and each rank
reads its own x and z channels (the backward reduce-scatters the
cotangent). `x_proj` and `out_proj` are row-parallel: one all-reduce
each. Three "tp" collectives a layer in the forward
(`collectives_from_shapes`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers, rowfold, tp


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


def _own(v: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """A replicated (di,) leaf's entries for this rank's n channels from
    lo; every rank's gradient of it summed over "model". The leaf as it
    is where the rank runs every channel."""
    if n == v.shape[0]:
        return v
    return tp.copy_to_model(v).narrow(0, lo, n)


def _in_proj(w: torch.Tensor, x: torch.Tensor, di: int, n: int, lo: int):
    """This rank's x and z channels (lo .. lo + n - 1 of each) of
    x @ in_proj. Inside a `tp.scope` `in_proj`'s column blocks of
    (d, 2 di) are gathered over "model" and each rank reads its own
    channels of the result, so the backward sums the cotangent over the
    ranks and hands each its block (a reduce-scatter); with every
    channel on every rank (n == di) the gathered product is read whole
    alike on every rank."""
    if tp.split(w.shape[-1], 2 * di) == 1:
        if n != di:
            raise ValueError("a whole in_proj beside d_inner blocks")
        xz = x @ w
    else:
        xz = tp.gather_from_model(tp.copy_to_model(x) @ w, -1,
                                  own_parts=n != di)
    return xz.narrow(-1, lo, n), xz.narrow(-1, di + lo, n)


def _ssm_params(p, cfg, x_c, lo: int, n: int):
    """x_c (B,T,n) -> dt (B,T,n), Bm/Cm (B,T,d_state) in f32. Inside a
    `tp.scope`, with `x_proj` in row blocks, its partial products are
    summed over "model" and each rank reads the sums for its own
    channels (the cotangent summed back over the ranks)."""
    s = cfg.ssm
    dtr = _dt_rank(cfg)
    proj = x_c @ p["x_proj"]
    if tp.split(p["x_proj"].shape[0], d_inner(cfg)) > 1:
        proj = tp.copy_to_model(tp.reduce_from_model(proj))
    dt_in, Bm, Cm = torch.split(proj.to(torch.float32),
                                [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt_in @ p["dt_w"].to(torch.float32)
                    + _own(p["dt_b"], lo, n))
    return dt, Bm, Cm


# ------------------------------------------------------ the scan as an op


def scan_chunk(t: int) -> int:
    """The steps between two of the backward's kept states:
    ceil(sqrt(T))."""
    return math.isqrt(t - 1) + 1


def scan_workspace(rows: int, t: int, di: int, n: int,
                   backward: bool) -> int:
    """The bytes one call holds beside its operands and results: a few
    f32 (rows, di, n) states a step; the backward also every chunk's
    first state and one chunk's states (`scan_chunk`)."""
    state = rows * di * n * 4
    if not backward:
        return 3 * state
    c = scan_chunk(t)
    return (-(-t // c) + c + 1 + 5) * state


def _decay(A: torch.Tensor, dt_t: torch.Tensor) -> torch.Tensor:
    """exp(dt_t * A): A (di, n) shared by the rows or (R, di, n) one a
    row."""
    return torch.exp(dt_t[..., None] * (A[None] if A.dim() == 2 else A))


def _step(h, x, dt, Bm, A, i: int):
    """The state after step i from the state before it (f32)."""
    x_t, dt_t = x[:, i].to(torch.float32), dt[:, i]
    B_t = Bm[:, i].to(torch.float32)
    return _decay(A, dt_t) * h + (dt_t * x_t)[..., None] * B_t[:, None, :]


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over rows R: x (R,T,di) and Bm / Cm (R,T,n)
    in the stream dtype, dt (R,T,di) f32, A (di,n) or (R,di,n) f32,
    h0 (R,di,n) f32. Returns y (R,T,di) f32, without the D skip, and
    the final state (R,di,n) f32."""
    y = x.new_empty(x.shape, dtype=torch.float32)
    h = h0
    for i in range(x.shape[1]):
        h = _step(h, x, dt, Bm, A, i)
        y[:, i] = torch.einsum("bdn,bn->bd", h,
                               Cm[:, i].to(torch.float32))
    return y, h


@selective_scan.register_fake
def _(x, dt, Bm, Cm, A, h0):
    return x.new_empty(x.shape, dtype=torch.float32), torch.empty_like(h0)


@torch.library.custom_op("repro_torch::selective_scan_backward",
                         mutates_args=())
def selective_scan_backward(
        gy: torch.Tensor, gh: torch.Tensor, x: torch.Tensor,
        dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        A: torch.Tensor, h0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """The gradients of `selective_scan`'s inputs, each in its dtype and
    layout, from those of its outputs (gy, gh). Reruns the recurrence:
    once keeping every chunk's first state, then chunk by chunk from the
    last, each chunk's states rerun from its first (module docstring)."""
    f32 = torch.float32
    t = x.shape[1]
    c = scan_chunk(t)
    starts = []
    h = h0
    for i in range(t):
        if i % c == 0:
            starts.append(h)
        h = _step(h, x, dt, Bm, A, i)
    gx, gdt = torch.empty_like(x), torch.empty_like(dt)
    gB, gC = torch.empty_like(Bm), torch.empty_like(Cm)
    gA = torch.zeros_like(h0)  # a row's share, summed below if shared
    G = gh
    for k in reversed(range(len(starts))):
        lo, hi = k * c, min(t, (k + 1) * c)
        hs = [starts.pop()]
        for i in range(lo, hi):
            hs.append(_step(hs[-1], x, dt, Bm, A, i))
        for i in reversed(range(lo, hi)):
            h_t, h_prev = hs.pop(), hs[-1]
            x_t, dt_t = x[:, i].to(f32), dt[:, i]
            B_t, C_t, gy_t = Bm[:, i].to(f32), Cm[:, i].to(f32), gy[:, i]
            G = G + gy_t[..., None] * C_t[:, None, :]
            gC[:, i] = torch.einsum("bdn,bd->bn", h_t, gy_t)
            gu = torch.einsum("bdn,bn->bd", G, B_t)
            gx[:, i] = gu * dt_t
            gB[:, i] = torch.einsum("bdn,bd->bn", G, dt_t * x_t)
            decay = _decay(A, dt_t)
            gz = G * h_prev * decay
            gdt[:, i] = gu * x_t + torch.sum(
                gz * (A[None] if A.dim() == 2 else A), dim=-1)
            gA = gA + gz * dt_t[..., None]
            G = G * decay
    return gx, gdt, gB, gC, (gA if A.dim() == 3 else gA.sum(0)), G


@selective_scan_backward.register_fake
def _(gy, gh, x, dt, Bm, Cm, A, h0):
    return tuple(torch.empty_like(z) for z in (x, dt, Bm, Cm, A, h0))


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _scan_grads(ctx, gy, gh):
    return selective_scan_backward(gy, gh, *ctx.saved_tensors)


selective_scan.register_autograd(_scan_grads, setup_context=_scan_setup)

_KINDS = ("rows",) * 4 + ("shared", "rows")  # x, dt, Bm, Cm, A, h0
_BASES = (0,) * 4 + (2, 0)


@selective_scan.register_vmap
def _(info, in_dims, *args):
    f = rowfold.Fold(info, in_dims, args, _KINDS, _BASES)
    y, h = selective_scan(*f.args)
    return (f.unfold(y)[0], f.unfold(h)[0]), (0, 0)


@selective_scan_backward.register_vmap
def _(info, in_dims, *args):
    f = rowfold.Fold(info, in_dims, args, ("rows",) * 2 + _KINDS,
                     (0,) * 2 + _BASES, per_row_shared=True)
    gx, gdt, gB, gC, gA, gh0 = selective_scan_backward(*f.args)
    gA, a_dim = f.unfold_grad(gA, 0)
    return ((*(f.unfold(g)[0] for g in (gx, gdt, gB, gC)), gA,
             f.unfold(gh0)[0]), (0, 0, 0, 0, a_dim, 0))


class _Scan(torch.autograd.Function):
    """`selective_scan` with `selective_scan_backward` as its backward,
    under plain autograd and `torch.func` alike (its `vmap` rule is
    generated, and reaches the ops' own)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, dt, Bm, Cm, A, h0):
        return selective_scan(x, dt, Bm, Cm, A, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy, gh):
        # no graph of the backward: the cotangents and inputs detached
        return selective_scan_backward(
            gy.detach(), gh.detach(), *(z.detach() for z in
                                        ctx.saved_tensors))


def scan(x, dt, Bm, Cm, A, h0):
    """(y, h_final) of the selective scan, differentiable (`_Scan`)."""
    return _Scan.apply(x, dt, Bm, Cm, A, h0)


# ----------------------------------------------------------- the block


def mamba_forward(p: dict, cfg, x: torch.Tensor, state: dict | None):
    """x (B,T,d). state: None or {"h": (B,di,n), "conv": (B,K-1,di)}
    (inside a `tp.scope` the rank's channel blocks of both).

    Returns (y (B,T,d), new_state)."""
    f32 = torch.float32
    di = d_inner(cfg)
    n = p["conv_w"].shape[-1]  # this rank's channels: di or a block
    lo = tp.block_start(n) if tp.split(n, di) > 1 else 0
    x_in, z = _in_proj(p["in_proj"], x, di, n, lo)
    buf = None if state is None else state["conv"]
    x_c, new_buf = _conv_causal(x_in, p["conv_w"], _own(p["conv_b"], lo, n),
                                buf)
    x_c = F.silu(x_c)

    dt, Bm, Cm = _ssm_params(p, cfg, x_c, lo, n)
    A = -torch.exp(p["A_log"])  # (n, d_state)
    h = (x.new_zeros((x.shape[0], n, cfg.ssm.d_state), dtype=f32)
         if state is None else state["h"].to(f32))
    # the x / B / C streams are stored in the stream dtype; dt stays f32
    sdt = getattr(torch, cfg.ssm.stream_dtype)
    xcf, Bm, Cm = (t.to(sdt) for t in (x_c.to(f32), Bm, Cm))
    y, h = scan(xcf, dt, Bm, Cm, A, h)
    y = y + _own(p["D"], lo, n) * xcf  # (B,T,n)
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if n != di:  # out_proj's row block: the partial products summed
        y = tp.reduce_from_model(y)
    return y, {"h": h, "conv": new_buf}


def collectives_from_shapes(cfg, b: int, t: int, m: int) -> list:
    """The "tp" collectives of one Mamba layer's forward over b rows of
    t positions on a model axis of m > 1 ranks that splits d_inner:
    [(op, shape of this rank's tensor)]: `in_proj`'s output gathered
    (the rank's block sent), `x_proj`'s and `out_proj`'s partial
    products all-reduced."""
    di = d_inner(cfg)
    return [("all_gather", (b, t, 2 * di // m)),
            ("all_reduce", (b, t, _dt_rank(cfg) + 2 * cfg.ssm.d_state)),
            ("all_reduce", (b, t, cfg.d_model))]


def init_state(cfg, b: int, device=None) -> dict:
    di = d_inner(cfg)
    return {
        "h": torch.zeros((b, di, cfg.ssm.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((b, cfg.ssm.d_conv - 1, di), dtype=cfg.tdtype,
                            device=device),
    }
