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

Inside a `tp.scope` MLA runs head-parallel, each leaf's split read from
its width (`_layout`): `wq` / `wq_b`, `wk_b` and `wv_b` are column
blocks of whole heads where H % M == 0, `wo` a row block whose partial
product is summed over "model"; `wkv_a`, `kv_norm`, `wq_a` and `q_norm`
are replicated, and so are the latents they make, which pass
`tp.copy_to_model` where they feed the rank's heads. The latent cache
has no head dim: every rank holds it whole. The absorbed decode reads
`wk_b` / `wv_b` as the rank's H/M heads. Where the blocks do not hold
whole heads (H = 4 on M = 8) the projections' outputs are gathered, as
in `attention._tp_qkv`, attention runs on all heads on every rank, and
`wo` reads the rank's rows of its input; the absorbed decode then
gathers `wk_b` and `wv_b` themselves. Where the scope puts the cache's
sequence on "data" a rank holds a block of the latent positions, as in
`attention.attn_decode`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers, tp

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


def _layout(p, cfg) -> tuple[bool, int]:
    """(local, heads): whether this rank attends over its own H/M heads
    (inside a `tp.scope`, every head projection a block of whole heads),
    and how many heads it attends over."""
    m, H = cfg.mla, cfg.num_heads
    size = tp.model_size()
    q_w = p["wq_b"] if m.q_lora_rank else p["wq"]
    widths = ((q_w, m.nope_head_dim + m.rope_head_dim),
              (p["wk_b"], m.nope_head_dim), (p["wv_b"], m.v_head_dim))
    local = H % size == 0 and all(tp.split(w.shape[-1], H * width) > 1
                                  for w, width in widths)
    return local, H // size if local else H


def _proj(z, w, width: int, cfg, local: bool):
    """z @ w for a projection onto the heads (`width` columns a head):
    this rank's heads where `local`, else all heads (its output gathered
    where w is a block)."""
    if tp.split(w.shape[-1], cfg.num_heads * width) == 1:
        return z @ w
    y = tp.copy_to_model(z) @ w
    return y if local else tp.gather_from_model(y, -1)


def _out(out, wo, cfg, local: bool):
    """out (B, T, heads * v) @ wo: row-parallel and summed over "model"
    where wo is a block (on all heads, over the rank's rows of out)."""
    rows = wo.shape[0]
    if tp.split(rows, cfg.num_heads * cfg.mla.v_head_dim) == 1:
        if local:
            out = tp.gather_from_model(out, -1)
        return out @ wo
    if not local:
        out = tp.copy_to_model(out).narrow(-1, tp.block_start(rows), rows)
    return tp.reduce_from_model(out @ wo)


def _queries(p, cfg, x, cos, sin, local: bool, heads: int):
    m = cfg.mla
    width = m.nope_head_dim + m.rope_head_dim
    if m.q_lora_rank:
        q = _proj(layers.norm_apply(p["q_norm"], x @ p["wq_a"]), p["wq_b"],
                  width, cfg, local)
    else:
        q = _proj(x, p["wq"], width, cfg, local)
    q = q.reshape(x.shape[0], x.shape[1], heads, width)
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
    local, H = _layout(p, cfg)
    f32 = torch.float32
    q_nope, q_rope = _queries(p, cfg, x, cos, sin, local, H)
    c_kv, k_rope = _latents(p, cfg, x, cos, sin)
    k_nope = _proj(c_kv, p["wk_b"], m.nope_head_dim, cfg, local).reshape(
        b, t, H, m.nope_head_dim)
    v = _proj(c_kv, p["wv_b"], m.v_head_dim, cfg, local).reshape(
        b, t, H, m.v_head_dim)
    # the shared rope key feeds this rank's heads only where `local`
    k_rope_h = tp.copy_to_model(k_rope) if local else k_rope

    s = torch.einsum("bthe,bshe->bhts", q_nope.to(f32), k_nope.to(f32))
    s = s + torch.einsum("bthe,bse->bhts", q_rope.to(f32),
                         k_rope_h.to(f32))
    mask = (torch.arange(t, device=x.device)[None, :]
            <= torch.arange(t, device=x.device)[:, None])
    probs = torch.softmax(torch.where(mask, s * _scale(m),
                                      torch.full_like(s, NEG_INF)), dim=-1)
    out = torch.einsum("bhts,bshe->bthe", probs, v.to(f32))
    y = _out(out.reshape(b, t, H * m.v_head_dim).to(x.dtype), p["wo"], cfg,
             local)

    cache = None
    if return_cache:
        assert max_len >= t
        ck = c_kv.new_zeros((b, max_len, m.kv_lora_rank))
        cr = k_rope.new_zeros((b, max_len, m.rope_head_dim))
        ck[:, :t] = c_kv
        cr[:, :t] = k_rope
        cache = {"ckv": tp.own_positions(ck), "krope": tp.own_positions(cr)}
    return y, cache


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: int, cos,
               sin):
    """Absorbed single-token decode against the latent cache. x (B,1,d);
    pos the absolute position (int). Returns (y, cache)."""
    m = cfg.mla
    b = x.shape[0]
    local, H = _layout(p, cfg)
    f32 = torch.float32
    q_nope, q_rope = _queries(p, cfg, x, cos, sin, local, H)  # (B,1,H,*)
    c_kv, k_rope = _latents(p, cfg, x, cos, sin)  # (B,1,r), (B,1,rd)
    ckv, krope = cache["ckv"], cache["krope"]
    # the reference's dynamic_update_slice clamps the start into range;
    # where the sequence is on "data" the rank holds positions lo ..
    # lo + S_loc - 1 and writes the slot it owns
    s_loc = ckv.shape[1]
    lo = tp.seq_block(s_loc)
    slot = min(pos, s_loc * tp.seq_blocks() - 1) - lo
    if 0 <= slot < s_loc:
        ckv[:, slot:slot + 1] = c_kv
        krope[:, slot:slot + 1] = k_rope

    # absorb W_uk into the query: q_lat (B,1,H,r), over the rank's heads
    # where `local`, else over all (a block of part heads gathered)
    wk_b, wv_b = p["wk_b"], p["wv_b"]
    if not local:
        wk_b, wv_b = (tp.gather_from_model(w, -1) if tp.split(
            w.shape[-1], H * width) > 1 else w for w, width in (
                (wk_b, m.nope_head_dim), (wv_b, m.v_head_dim)))
    wk_b = wk_b.reshape(m.kv_lora_rank, H, m.nope_head_dim)
    q_lat = torch.einsum("bthe,rhe->bthr", q_nope.to(f32), wk_b.to(f32))
    s = torch.einsum("bthr,bsr->bhts", q_lat, ckv.to(f32))
    s = s + torch.einsum("bthe,bse->bhts", q_rope.to(f32), krope.to(f32))
    valid = torch.arange(lo, lo + s_loc, device=x.device) <= pos
    if tp.seq_over_data() is None:
        probs = torch.softmax(torch.where(valid[None, None, None, :],
                                          s * _scale(m),
                                          torch.full_like(s, NEG_INF)),
                              dim=-1)
        out_lat = torch.einsum("bhts,bsr->bthr", probs, ckv.to(f32))
    else:  # the ranks' blocks of the latent positions combined
        out_lat, sums = tp.combine_over_data(
            s * _scale(m), valid, lambda p_: torch.einsum(
                "bhts,bsr->bthr", p_, ckv.to(f32)))
        out_lat = out_lat / sums.permute(0, 2, 1)[..., None]
    wv_b = wv_b.reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bthr,rhe->bthe", out_lat, wv_b.to(f32))
    y = _out(out.reshape(b, 1, H * m.v_head_dim).to(x.dtype), p["wo"], cfg,
             local)
    return y, cache
