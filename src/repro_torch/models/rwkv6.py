"""RWKV-6 "Finch" block: data-dependent-decay linear attention
(arXiv:2404.05892), the counterpart of `repro/models/rwkv6.py`.

The WKV state advances in chunks of `chunk_len`: intra-chunk
interactions are (L x L) matmuls and the state crosses chunk boundaries
in a loop over the chunks (the reference scans). The per-step log-decay
is clamped to [-40/chunk_len, -1e-6] so that exp(+-cumsum(log w)) stays
in f32 range; all WKV math is f32. T must divide by `chunk_len`.

The chunked WKV is one custom op, `repro_torch::wkv_chunked` (the
reference's `lax.scan` is one op as well): today's loop over the
chunks on every device, with a fake (meta) kernel, a `vmap` rule that
folds the vmapped dim into the batch rows (`rowfold`), and a backward
that is one op of its own, `repro_torch::wkv_chunked_backward`, written
out chunk by chunk from the last. It keeps the state entering every
chunk (`wkv_workspace`) and reruns each chunk's products, where the
loop's autograd kept every chunk's (L x L) scores and decayed r and k.
Its gradients are the loop's autograd's up to the order of the f32
sums. Training reaches the op through `_WKV`, an autograd Function
with a generated `vmap` rule, since `torch.func.grad` does not run a
custom op's own autograd. Decode (`time_mix_decode`) is one step and
needs no op.

As in the reference, the token-shift mixes of r / k / v / g are static
learned lerps (RWKV-5 style) and the decay keeps the paper's
data-dependent LoRA.

Inside a `tp.scope` a rank runs the heads of its blocks: `w_r`, `w_k`,
`w_v` and `w_g` are column blocks of whole heads (H % M == 0), and so
are the cache's `S`; the replicated `u`, `ln_x_*` and `w_base` are
narrowed to the rank's heads, and the decay LoRA is computed whole on
every rank with `decay_b`'s columns narrowed; `w_o` is row-parallel
(one all-reduce). In the channel mix `cw_k` is column-parallel and
`cw_v` row-parallel; `cw_r` is split on its output, so the partial
products of `cw_v` are reduce-scattered to each rank's columns, gated
by its `cw_r` block and all-gathered: three "tp" collectives a layer in
the forward (`collectives_from_shapes`). `tm_last` and `cm_last` are
replicated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers, rowfold, tp


def rwkv_init(cfg) -> dict:
    r = cfg.rwkv
    d = cfg.d_model
    H = d // r.head_dim
    dt = cfg.tdtype
    f32 = torch.float32

    def mix():
        return layers.uniform((d,), dt)

    return {
        # time mix
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_g": mix(),
        "mu_w": mix(),
        "w_r": layers.dense_init(d, d, dt),
        "w_k": layers.dense_init(d, d, dt),
        "w_v": layers.dense_init(d, d, dt),
        "w_g": layers.dense_init(d, d, dt),
        "w_o": layers.dense_init(d, d, dt),
        # data-dependent decay LoRA: logw = -exp(w_base + tanh(x A) B)
        "decay_a": layers.dense_init(d, r.decay_lora, dt),
        "decay_b": layers.normal((r.decay_lora, d), 0.01, dt),
        "w_base": layers.full((d,), 0.0, f32),
        "u": layers.full((H, r.head_dim), 0.0, f32),  # bonus
        "ln_x_scale": layers.full((H, r.head_dim), 1.0, f32),
        "ln_x_bias": layers.full((H, r.head_dim), 0.0, f32),
        # channel mix
        "cmu_k": mix(), "cmu_r": mix(),
        "cw_k": layers.dense_init(d, cfg.d_ff, dt),
        "cw_v": layers.dense_init(cfg.d_ff, d, dt),
        "cw_r": layers.dense_init(d, d, dt),
    }


def _shift(x: torch.Tensor, last) -> torch.Tensor:
    """Token shift: x_{t-1}, with `last` (B, d) as position -1 (zeros if
    None)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def _decay_log(p, xw: torch.Tensor, chunk_len: int, heads=None):
    """Per-channel log-decay in [-40/chunk_len, -1e-6]. `heads`, inside
    a `tp.scope` (`_Heads`), narrows it to the rank's channels: the LoRA
    is computed whole and `decay_b`'s and `w_base`'s columns narrowed."""
    lora = torch.tanh(xw @ p["decay_a"])
    decay_b, w_base = p["decay_b"], p["w_base"]
    if heads is not None and heads.split:
        lora = tp.copy_to_model(lora)
        decay_b, w_base = heads.own(decay_b, 1), heads.own(w_base, 0)
    logw = -torch.exp(w_base.to(torch.float32)
                      + (lora @ decay_b).to(torch.float32))
    return torch.clamp(logw, -40.0 / chunk_len, -1e-6)


# ------------------------------------------------------- the WKV as an op


def wkv_workspace(b: int, nc: int, l_: int, h: int, e: int,
                  backward: bool) -> int:
    """The bytes one call holds beside its operands and results: a
    chunk's (L x L) scores and a few (B, L, H, e) products; the backward
    also the state entering every chunk."""
    chunk = b * h * (2 * l_ * l_ + 8 * l_ * e + 4 * e * e) * 4
    if not backward:
        return chunk
    return 2 * chunk + (nc + 1) * b * h * e * e * 4


def _bonus(u: torch.Tensor) -> torch.Tensor:
    """u (H, e) shared by the rows or (B, H, e) one a row, as
    (B | 1, 1, H, e)."""
    return u[None, None] if u.dim() == 2 else u[:, None]


def _chunk_fwd(rc, kc, vc, lwc, u, S, mask, eye):
    """One chunk: (its output (B, L, H, e), the state after it, and the
    products the backward reads)."""
    cw = torch.cumsum(lwc, dim=1)  # inclusive
    cwe = cw - lwc  # exclusive: cw_{t-1}
    r_t = rc * torch.exp(cwe)
    k_t = kc * torch.exp(-cw)
    scores = torch.einsum("blhe,bmhe->bhlm", r_t, k_t) * mask[None, None]
    diag = torch.einsum("blhe,blhe->bhl", rc, _bonus(u) * kc)
    scores = scores + torch.einsum("bhl,lm->bhlm", diag, eye)
    o_intra = torch.einsum("bhlm,bmhe->blhe", scores, vc)
    o_inter = torch.einsum("blhe,bhef->blhf", r_t, S)
    cw_last = cw[:, -1]  # (B, H, e)
    k_carry = kc * torch.exp(cw_last[:, None] - cw)
    S_new = S * torch.exp(cw_last)[..., None] + torch.einsum(
        "blhe,blhf->bhef", k_carry, vc)
    return o_intra + o_inter, S_new, (cw, cwe, r_t, k_t, scores, cw_last,
                                      k_carry)


def _consts(L: int, dev):
    mask = (torch.arange(L, device=dev)[:, None]
            > torch.arange(L, device=dev)[None, :]).to(torch.float32)
    return mask, torch.eye(L, dtype=torch.float32, device=dev)


@torch.library.custom_op("repro_torch::wkv_chunked", mutates_args=())
def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV. r/k/v/logw: (B, nC, L, H, e) f32; u (H, e) or one a
    row (B, H, e); S0 (B, H, e, e). Returns (out (B, T, H, e), the final
    state)."""
    b, nc, L, H, e = r.shape
    mask, eye = _consts(L, r.device)
    out = r.new_empty((b, nc * L, H, e))
    S = S0
    for c in range(nc):
        out[:, c * L:(c + 1) * L], S, _ = _chunk_fwd(
            r[:, c], k[:, c], v[:, c], logw[:, c], u, S, mask, eye)
    return out, S


@wkv_chunked.register_fake
def _(r, k, v, logw, u, S0):
    b, nc, L, H, e = r.shape
    return r.new_empty((b, nc * L, H, e)), torch.empty_like(S0)


@torch.library.custom_op("repro_torch::wkv_chunked_backward",
                         mutates_args=())
def wkv_chunked_backward(
        gout: torch.Tensor, gS: torch.Tensor, r: torch.Tensor,
        k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
        u: torch.Tensor, S0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """The gradients of `wkv_chunked`'s inputs, each in its layout, from
    those of its outputs (gout (B, T, H, e), gS): the states entering
    the chunks first, then chunk by chunk from the last, each chunk's
    products rerun from its state."""
    b, nc, L, H, e = r.shape
    mask, eye = _consts(L, r.device)
    states = [S0]
    for c in range(nc - 1):
        states.append(_chunk_fwd(r[:, c], k[:, c], v[:, c], logw[:, c], u,
                                 states[-1], mask, eye)[1])
    gr, gk, gv, glw = (torch.empty_like(z) for z in (r, k, v, logw))
    gu = torch.zeros((b, H, e), dtype=r.dtype, device=r.device)
    U = _bonus(u)
    for c in reversed(range(nc)):
        S = states.pop()
        rc, kc, vc = r[:, c], k[:, c], v[:, c]
        go = gout[:, c * L:(c + 1) * L]
        _, _, (cw, cwe, r_t, k_t, scores, cw_last, k_carry) = _chunk_fwd(
            rc, kc, vc, logw[:, c], u, S, mask, eye)
        g_scores = torch.einsum("blhf,bmhf->bhlm", go, vc)
        gv[:, c] = (torch.einsum("bhlm,blhf->bmhf", scores, go)
                    + torch.einsum("blhe,bhef->blhf", k_carry, gS))
        g_rt = torch.einsum("blhf,bhef->blhe", go, S)
        e_last = torch.exp(cw_last)
        g_last = torch.sum(gS * S, dim=-1) * e_last
        g_kc_carry = torch.einsum("bhef,blhf->blhe", gS, vc)
        gS_prev = (torch.einsum("blhe,blhf->bhef", r_t, go)
                   + gS * e_last[..., None])
        g_sm = g_scores * mask[None, None]
        g_diag = torch.diagonal(g_scores, dim1=-2, dim2=-1)  # (B, H, L)
        g_rt = g_rt + torch.einsum("bhlm,bmhe->blhe", g_sm, k_t)
        g_kt = torch.einsum("bhlm,blhe->bmhe", g_sm, r_t)
        gd = g_diag.permute(0, 2, 1)[..., None]  # (B, L, H, 1)
        g_rc = gd * U * kc + g_rt * torch.exp(cwe)
        gu = gu + torch.sum(gd * rc * kc, dim=1)
        g_kc = (gd * rc * U + g_kt * torch.exp(-cw)
                + g_kc_carry * torch.exp(cw_last[:, None] - cw))
        g_E = g_kc_carry * k_carry
        g_cw = g_rt * r_t - g_kt * k_t - g_E
        g_cw[:, -1] += g_last + torch.sum(g_E, dim=1)
        gr[:, c], gk[:, c] = g_rc, g_kc
        glw[:, c] = (torch.flip(torch.cumsum(torch.flip(g_cw, (1,)), 1),
                                (1,)) - g_rt * r_t)
        gS = gS_prev
    return gr, gk, gv, glw, (gu if u.dim() == 3 else gu.sum(0)), gS


@wkv_chunked_backward.register_fake
def _(gout, gS, r, k, v, logw, u, S0):
    return tuple(torch.empty_like(z) for z in (r, k, v, logw, u, S0))


def _wkv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _wkv_grads(ctx, gout, gS):
    return wkv_chunked_backward(gout, gS, *ctx.saved_tensors)


wkv_chunked.register_autograd(_wkv_grads, setup_context=_wkv_setup)

_KINDS = ("rows",) * 4 + ("shared", "rows")  # r, k, v, logw, u, S0
_BASES = (0,) * 4 + (2, 0)


@wkv_chunked.register_vmap
def _(info, in_dims, *args):
    f = rowfold.Fold(info, in_dims, args, _KINDS, _BASES)
    out, S = wkv_chunked(*f.args)
    return (f.unfold(out)[0], f.unfold(S)[0]), (0, 0)


@wkv_chunked_backward.register_vmap
def _(info, in_dims, *args):
    f = rowfold.Fold(info, in_dims, args, ("rows",) * 2 + _KINDS,
                     (0,) * 2 + _BASES, per_row_shared=True)
    gr, gk, gv, glw, gu, gS0 = wkv_chunked_backward(*f.args)
    gu, u_dim = f.unfold_grad(gu, 0)
    return ((*(f.unfold(g)[0] for g in (gr, gk, gv, glw)), gu,
             f.unfold(gS0)[0]), (0, 0, 0, 0, u_dim, 0))


class _WKV(torch.autograd.Function):
    """`wkv_chunked` with `wkv_chunked_backward` as its backward, under
    plain autograd and `torch.func` alike (its `vmap` rule is
    generated, and reaches the ops' own)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(r, k, v, logw, u, S0):
        return wkv_chunked(r, k, v, logw, u, S0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gout, gS):
        # no graph of the backward: the cotangents and inputs detached
        return wkv_chunked_backward(
            gout.detach(), gS.detach(), *(z.detach() for z in
                                          ctx.saved_tensors))


def wkv(r, k, v, logw, u, S0):
    """(out, final state) of the chunked WKV, differentiable (`_WKV`)."""
    return _WKV.apply(r, k, v, logw, u, S0)


# ----------------------------------------------------------- the block


class _Heads:
    """The heads a rank runs: every head (`split` False), or inside a
    `tp.scope` the whole heads of its column blocks of `w_r`."""

    def __init__(self, p, cfg):
        e, d = cfg.rwkv.head_dim, cfg.d_model
        cols = p["w_r"].shape[-1]
        self.split = tp.split(cols, d) > 1
        if self.split and (d // e) % tp.model_size():
            raise NotImplementedError(
                f"{cfg.name}: RWKV-6 over a model axis of "
                f"{tp.model_size()} ranks: its {d // e} heads do not "
                "divide into whole heads a rank")
        self.n, self.lo = cols // e, tp.block_start(cols // e)
        self.H, self.e = d // e, e

    def own(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """A replicated leaf's entries along `dim` (H heads, or d
        channels) for this rank's heads; every rank's gradient of it
        summed over "model"."""
        if not self.split:
            return w
        per = 1 if w.shape[dim] == self.H else self.e
        return tp.copy_to_model(w).narrow(dim, self.lo * per, self.n * per)


def _heads(t, b, H, e):
    return t.reshape(b, -1, H, e).to(torch.float32)


def _mixes(p, x, xs, chunk_len, heads):
    """The time mix's r, k, v, gate and log-decay from x and its shift,
    for the rank's heads."""
    z = [_lerp(x, xs, p[mu]) for mu in ("mu_r", "mu_k", "mu_v", "mu_g")]
    if heads.split:  # the lerps feed this rank's column blocks
        z = tp.copy_to_model(torch.stack(z)).unbind(0)
    rr, kk, vv = z[0] @ p["w_r"], z[1] @ p["w_k"], z[2] @ p["w_v"]
    gg = F.silu(z[3] @ p["w_g"])
    logw = _decay_log(p, _lerp(x, xs, p["mu_w"]), chunk_len, heads)
    return rr, kk, vv, gg, logw


def _out(p, out, gg, x, heads):
    """The rank's heads' output through `w_o` (its row block: the
    partial products summed over "model")."""
    y = (out.reshape(x.shape[0], x.shape[1], -1).to(x.dtype) * gg) \
        @ p["w_o"]
    return tp.reduce_from_model(y) if heads.split else y


def time_mix(p, cfg, x, state):
    """x (B,T,d) normed input; state None (train / prefill) or a dict
    {"S", "tm_last"}. Returns (y, new_state)."""
    r_cfg = cfg.rwkv
    e = r_cfg.head_dim
    heads = _Heads(p, cfg)
    H = heads.n
    b, t, _ = x.shape
    last = None if state is None else state["tm_last"]
    rr, kk, vv, gg, logw = _mixes(p, x, _shift(x, last), r_cfg.chunk_len,
                                  heads)
    S0 = (torch.zeros((b, H, e, e), dtype=torch.float32, device=x.device)
          if state is None else state["S"].to(torch.float32))
    L = r_cfg.chunk_len
    assert t % L == 0, f"T={t} not divisible by rwkv chunk_len={L}"

    def chunkify(z):
        return _heads(z, b, H, e).reshape(b, t // L, L, H, e)

    out, S_fin = wkv(chunkify(rr), chunkify(kk), chunkify(vv),
                     chunkify(logw), heads.own(p["u"], 0).to(torch.float32),
                     S0)
    out = layers.groupnorm_heads(out, heads.own(p["ln_x_scale"], 0),
                                 heads.own(p["ln_x_bias"], 0))
    return _out(p, out, gg, x, heads), {"S": S_fin, "tm_last": x[:, -1]}


def time_mix_decode(p, cfg, x, state):
    """Single-token recurrent step. x (B,1,d). Returns (y, new_state)."""
    e = cfg.rwkv.head_dim
    heads = _Heads(p, cfg)
    H = heads.n
    b = x.shape[0]
    rr, kk, vv, gg, logw = _mixes(p, x, state["tm_last"][:, None],
                                  cfg.rwkv.chunk_len, heads)
    r1, k1, v1, w1 = (_heads(z, b, H, e)[:, 0]
                      for z in (rr, kk, vv, logw))
    S = state["S"].to(torch.float32)  # (B,H,e,e)
    u = heads.own(p["u"], 0).to(torch.float32)
    wkv_ = S + (u[None] * k1)[..., None] * v1[..., None, :]
    o = torch.einsum("bhe,bhef->bhf", r1, wkv_)  # (B,H,e)
    S_new = S * torch.exp(w1)[..., None] + k1[..., None] * v1[..., None, :]
    o = layers.groupnorm_heads(o, heads.own(p["ln_x_scale"], 0),
                               heads.own(p["ln_x_bias"], 0))
    return _out(p, o, gg, x, heads), {"S": S_new, "tm_last": x[:, -1]}


def channel_mix(p, x, last):
    """RWKV channel mix (relu^2). last: (B,d) or None. Returns
    (y, new_last). Inside a `tp.scope` (module docstring) the rank's
    `cw_k` columns and `cw_v` rows make partial products, summed and
    scattered over "model" to the columns of its `cw_r` block, gated
    there and gathered."""
    xs = _shift(x, last)
    zk, zr = _lerp(x, xs, p["cmu_k"]), _lerp(x, xs, p["cmu_r"])
    if tp.split(p["cw_r"].shape[-1], x.shape[-1]) == 1:
        k = zk @ p["cw_k"]
        kv = torch.square(F.relu(k)) @ p["cw_v"]
        r = torch.sigmoid(zr @ p["cw_r"])
        return r * kv, x[:, -1]
    zk, zr = tp.copy_to_model(torch.stack([zk, zr])).unbind(0)
    kv = tp.scatter_to_model(torch.square(F.relu(zk @ p["cw_k"]))
                             @ p["cw_v"], -1)
    r = torch.sigmoid(zr @ p["cw_r"])
    return tp.gather_from_model(r * kv, -1), x[:, -1]


def collectives_from_shapes(cfg, b: int, t: int, m: int) -> list:
    """The "tp" collectives of one RWKV-6 layer's forward over b rows of
    t positions on a model axis of m > 1 ranks that splits its heads:
    [(op, shape of this rank's tensor)]: `w_o`'s partial products
    all-reduced, `cw_v`'s reduce-scattered, the gated columns gathered
    (the rank's block sent)."""
    d = cfg.d_model
    return [("all_reduce", (b, t, d)), ("reduce_scatter", (b, t, d)),
            ("all_gather", (b, t, d // m))]


def init_state(cfg, b: int, device=None) -> dict:
    e = cfg.rwkv.head_dim
    H = cfg.d_model // e
    return {
        "S": torch.zeros((b, H, e, e), dtype=torch.float32, device=device),
        "tm_last": torch.zeros((b, cfg.d_model), dtype=cfg.tdtype,
                               device=device),
        "cm_last": torch.zeros((b, cfg.d_model), dtype=cfg.tdtype,
                               device=device),
    }
