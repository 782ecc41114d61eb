"""RWKV-6 "Finch" block: data-dependent-decay linear attention
(arXiv:2404.05892), the counterpart of `repro/models/rwkv6.py`.

The WKV state advances in chunks of `chunk_len`: intra-chunk
interactions are (L x L) matmuls and the state crosses chunk boundaries
in a loop over the chunks (the reference scans). The per-step log-decay
is clamped to [-40/chunk_len, -1e-6] so that exp(+-cumsum(log w)) stays
in f32 range; all WKV math is f32. T must divide by `chunk_len`.

As in the reference, the token-shift mixes of r / k / v / g are static
learned lerps (RWKV-5 style) and the decay keeps the paper's
data-dependent LoRA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


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


def _decay_log(p, xw: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """Per-channel log-decay in [-40/chunk_len, -1e-6]."""
    lora = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
    logw = -torch.exp(p["w_base"].to(torch.float32)
                      + lora.to(torch.float32))
    return torch.clamp(logw, -40.0 / chunk_len, -1e-6)


def _wkv_chunked(r, k, v, logw, u, state):
    """Chunked WKV. r/k/v/logw: (B, nC, L, H, e) f32; u (H, e); state
    (B, H, e, e). Returns (out (B, T, H, e), final_state)."""
    b, nc, L, H, e = r.shape
    dev = r.device
    mask = (torch.arange(L, device=dev)[:, None]
            > torch.arange(L, device=dev)[None, :]).to(torch.float32)
    eye = torch.eye(L, dtype=torch.float32, device=dev)
    S = state
    outs = []
    for c in range(nc):
        rc, kc, vc, lwc = r[:, c], k[:, c], v[:, c], logw[:, c]
        cw = torch.cumsum(lwc, dim=1)  # inclusive
        cwe = cw - lwc  # exclusive: cw_{t-1}
        r_t = rc * torch.exp(cwe)
        k_t = kc * torch.exp(-cw)
        scores = torch.einsum("blhe,bmhe->bhlm", r_t, k_t) * mask[None, None]
        diag = torch.einsum("blhe,blhe->bhl", rc, u[None, None] * kc)
        scores = scores + torch.einsum("bhl,lm->bhlm", diag, eye)
        o_intra = torch.einsum("bhlm,bmhe->blhe", scores, vc)
        o_inter = torch.einsum("blhe,bhef->blhf", r_t, S)
        cw_last = cw[:, -1]  # (B, H, e)
        k_carry = kc * torch.exp(cw_last[:, None] - cw)
        S = S * torch.exp(cw_last)[..., None] + torch.einsum(
            "blhe,blhf->bhef", k_carry, vc)
        outs.append(o_intra + o_inter)
    return torch.stack(outs, dim=1).reshape(b, nc * L, H, e), S


def _heads(t, b, H, e):
    return t.reshape(b, -1, H, e).to(torch.float32)


def _mixes(p, x, xs, chunk_len):
    """The time mix's r, k, v, gate and log-decay from x and its shift."""
    rr = _lerp(x, xs, p["mu_r"]) @ p["w_r"]
    kk = _lerp(x, xs, p["mu_k"]) @ p["w_k"]
    vv = _lerp(x, xs, p["mu_v"]) @ p["w_v"]
    gg = F.silu(_lerp(x, xs, p["mu_g"]) @ p["w_g"])
    logw = _decay_log(p, _lerp(x, xs, p["mu_w"]), chunk_len)
    return rr, kk, vv, gg, logw


def time_mix(p, cfg, x, state):
    """x (B,T,d) normed input; state None (train / prefill) or a dict
    {"S", "tm_last"}. Returns (y, new_state)."""
    r_cfg = cfg.rwkv
    e = r_cfg.head_dim
    d = cfg.d_model
    H = d // e
    b, t, _ = x.shape
    last = None if state is None else state["tm_last"]
    rr, kk, vv, gg, logw = _mixes(p, x, _shift(x, last), r_cfg.chunk_len)
    S0 = (torch.zeros((b, H, e, e), dtype=torch.float32, device=x.device)
          if state is None else state["S"].to(torch.float32))
    L = r_cfg.chunk_len
    assert t % L == 0, f"T={t} not divisible by rwkv chunk_len={L}"

    def chunkify(z):
        return _heads(z, b, H, e).reshape(b, t // L, L, H, e)

    out, S_fin = _wkv_chunked(chunkify(rr), chunkify(kk), chunkify(vv),
                              chunkify(logw), p["u"].to(torch.float32), S0)
    out = layers.groupnorm_heads(out, p["ln_x_scale"], p["ln_x_bias"])
    y = (out.reshape(b, t, d).to(x.dtype) * gg) @ p["w_o"]
    return y, {"S": S_fin, "tm_last": x[:, -1]}


def time_mix_decode(p, cfg, x, state):
    """Single-token recurrent step. x (B,1,d). Returns (y, new_state)."""
    e = cfg.rwkv.head_dim
    d = cfg.d_model
    H = d // e
    b = x.shape[0]
    rr, kk, vv, gg, logw = _mixes(p, x, state["tm_last"][:, None],
                                  cfg.rwkv.chunk_len)
    r1, k1, v1, w1 = (_heads(z, b, H, e)[:, 0]
                      for z in (rr, kk, vv, logw))
    S = state["S"].to(torch.float32)  # (B,H,e,e)
    u = p["u"].to(torch.float32)
    wkv = S + (u[None] * k1)[..., None] * v1[..., None, :]
    o = torch.einsum("bhe,bhef->bhf", r1, wkv)  # (B,H,e)
    S_new = S * torch.exp(w1)[..., None] + k1[..., None] * v1[..., None, :]
    o = layers.groupnorm_heads(o, p["ln_x_scale"], p["ln_x_bias"])
    y = (o.reshape(b, 1, d).to(x.dtype) * gg) @ p["w_o"]
    return y, {"S": S_new, "tm_last": x[:, -1]}


def channel_mix(p, x, last):
    """RWKV channel mix (relu^2). last: (B,d) or None. Returns
    (y, new_last)."""
    xs = _shift(x, last)
    k = _lerp(x, xs, p["cmu_k"]) @ p["cw_k"]
    kv = torch.square(F.relu(k)) @ p["cw_v"]
    r = torch.sigmoid(_lerp(x, xs, p["cmu_r"]) @ p["cw_r"])
    return r * kv, x[:, -1]


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
