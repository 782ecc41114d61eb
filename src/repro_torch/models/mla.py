"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the
counterpart of `repro/models/mla.py`.

K/V are compressed into a shared latent c_kv (kv_lora_rank) plus one
shared RoPE key head. Train and prefill run the expanded form; decode
runs the *absorbed* form against the latent cache {"ckv", "krope"}:
W_uk folds into the query and W_uv into the output. RoPE runs at
`mla.rope_head_dim`; the scale is 1/sqrt(nope + rope) and masking uses
NEG_INF = -1e30, as in the reference, whose sharding constraints
(`act_constrain`) have no counterpart here. `mla_decode` writes the
token's latents into the cache in place and returns that cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers

NEG_INF = -1e30


def mla_init(cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    dt = cfg.tdtype
    p = {
        "wkv_a": layers.dense_init(d, m.kv_lora_rank + m.rope_head_dim, dt),
        "kv_norm": layers.norm_init(m.kv_lora_rank, "rmsnorm", dt),
        "wk_b": layers.dense_init(m.kv_lora_rank, H * m.nope_head_dim, dt),
        "wv_b": layers.dense_init(m.kv_lora_rank, H * m.v_head_dim, dt),
        "wo": layers.dense_init(H * m.v_head_dim, d, dt),
    }
    q_out = H * (m.nope_head_dim + m.rope_head_dim)
    if m.q_lora_rank:
        p["wq_a"] = layers.dense_init(d, m.q_lora_rank, dt)
        p["q_norm"] = layers.norm_init(m.q_lora_rank, "rmsnorm", dt)
        p["wq_b"] = layers.dense_init(m.q_lora_rank, q_out, dt)
    else:
        p["wq"] = layers.dense_init(d, q_out, dt)
    return p


def _scale(m) -> float:
    """1 / sqrt(nope + rope) in f32, as the reference computes it; a
    host scalar, so that no call copies it to the device."""
    return float(np.float32(1.0) / np.sqrt(np.float32(
        m.nope_head_dim + m.rope_head_dim)))


def _queries(p, cfg, x, cos, sin):
    m = cfg.mla
    H = cfg.num_heads
    if m.q_lora_rank:
        q = layers.norm_apply(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(x.shape[0], x.shape[1], H,
                  m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, layers.rope_apply(q_rope, cos, sin)


def _latents(p, cfg, x, cos, sin):
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = layers.norm_apply(p["kv_norm"], c_kv)
    k_rope = layers.rope_apply(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def mla_forward(p: dict, cfg, x: torch.Tensor, cos, sin, *,
                return_cache: bool = False, max_len: int = 0):
    """Train / prefill: expanded (non-absorbed) causal attention over the
    sequence. Returns (y, cache|None); the cache holds `max_len`
    positions."""
    m = cfg.mla
    b, t, _ = x.shape
    H = cfg.num_heads
    f32 = torch.float32
    q_nope, q_rope = _queries(p, cfg, x, cos, sin)
    c_kv, k_rope = _latents(p, cfg, x, cos, sin)
    k_nope = (c_kv @ p["wk_b"]).reshape(b, t, H, m.nope_head_dim)
    v = (c_kv @ p["wv_b"]).reshape(b, t, H, m.v_head_dim)

    s = torch.einsum("bthe,bshe->bhts", q_nope.to(f32), k_nope.to(f32))
    s = s + torch.einsum("bthe,bse->bhts", q_rope.to(f32), k_rope.to(f32))
    mask = (torch.arange(t, device=x.device)[None, :]
            <= torch.arange(t, device=x.device)[:, None])
    probs = torch.softmax(torch.where(mask, s * _scale(m),
                                      torch.full_like(s, NEG_INF)), dim=-1)
    out = torch.einsum("bhts,bshe->bthe", probs, v.to(f32))
    y = out.reshape(b, t, H * m.v_head_dim).to(x.dtype) @ p["wo"]

    cache = None
    if return_cache:
        assert max_len >= t
        ck = c_kv.new_zeros((b, max_len, m.kv_lora_rank))
        cr = k_rope.new_zeros((b, max_len, m.rope_head_dim))
        ck[:, :t] = c_kv
        cr[:, :t] = k_rope
        cache = {"ckv": ck, "krope": cr}
    return y, cache


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: int, cos,
               sin):
    """Absorbed single-token decode against the latent cache. x (B,1,d);
    pos the absolute position (int). Returns (y, cache)."""
    m = cfg.mla
    b = x.shape[0]
    H = cfg.num_heads
    f32 = torch.float32
    q_nope, q_rope = _queries(p, cfg, x, cos, sin)  # (B,1,H,*)
    c_kv, k_rope = _latents(p, cfg, x, cos, sin)  # (B,1,r), (B,1,rd)
    ckv, krope = cache["ckv"], cache["krope"]
    # the reference's dynamic_update_slice clamps the start into range
    slot = min(pos, ckv.shape[1] - 1)
    ckv[:, slot:slot + 1] = c_kv
    krope[:, slot:slot + 1] = k_rope

    # absorb W_uk into the query: q_lat (B,1,H,r)
    wk_b = p["wk_b"].reshape(m.kv_lora_rank, H, m.nope_head_dim)
    q_lat = torch.einsum("bthe,rhe->bthr", q_nope.to(f32), wk_b.to(f32))
    s = torch.einsum("bthr,bsr->bhts", q_lat, ckv.to(f32))
    s = s + torch.einsum("bthe,bse->bhts", q_rope.to(f32), krope.to(f32))
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    probs = torch.softmax(torch.where(valid[None, None, None, :],
                                      s * _scale(m),
                                      torch.full_like(s, NEG_INF)), dim=-1)
    out_lat = torch.einsum("bhts,bsr->bthr", probs, ckv.to(f32))
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bthr,rhe->bthe", out_lat, wv_b.to(f32))
    y = out.reshape(b, 1, H * m.v_head_dim).to(x.dtype) @ p["wo"]
    return y, cache
