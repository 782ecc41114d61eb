"""GQA/MQA attention with RoPE, sliding-window option, and KV-cache
decode, and the enc-dec family's cross-attention: the counterpart of
`repro/models/attention.py`.

Cache layout (per layer): {"k": (B, S, G, hd), "v": (B, S, G, hd)} with
S = max_len for full attention or S = window for the sliding-window ring
buffer. Keys are stored *already rotated*; decode only rotates the query.

Full-sequence attention takes the flash-attention kernel
(`kernels/flash_attn.py`) under the reference's own gate: causal, no
sliding window, `cfg.attention_impl == "flash"` and T % 64 == 0. That is
dispatch by config, not a fallback: on CUDA tensors the kernel runs or
raises. `attn_decode` writes the new key and value into the cache in
place (the reference returns an updated copy) and returns that cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn
from repro_torch.models import layers

NEG_INF = -1e30


def attn_init(cfg, d_in: int | None = None) -> dict:
    d = d_in or cfg.d_model
    hd = cfg.hd
    dt = cfg.tdtype
    return {
        "wq": layers.dense_init(d, cfg.num_heads * hd, dt),
        "wk": layers.dense_init(d, cfg.num_kv_heads * hd, dt),
        "wv": layers.dense_init(d, cfg.num_kv_heads * hd, dt),
        "wo": layers.dense_init(cfg.num_heads * hd, d, dt),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _scale(hd: int, device) -> torch.Tensor:
    """1 / sqrt(hd) computed in f32, as the reference does."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                         device=device))


def _gqa_scores(q, k, scale):
    """q (B,T,H,hd), k (B,S,G,hd) -> scores (B,G,H/G,T,S) in f32."""
    b, t, h, hd = q.shape
    g = k.shape[2]
    q = q.reshape(b, t, g, h // g, hd)
    return torch.einsum("btghe,bsge->bghts", q.to(torch.float32),
                        k.to(torch.float32)) * scale


def _gqa_out(probs, v):
    """probs (B,G,Hg,T,S), v (B,S,G,hd) -> (B,T,H*hd)."""
    b, g, hg, t, s = probs.shape
    out = torch.einsum("bghts,bsge->btghe", probs, v.to(torch.float32))
    return out.reshape(b, t, g * hg * v.shape[-1])


def _masked_softmax(scores, mask):
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1)


def full_mask(t: int, s: int, causal: bool, window: int, offset: int = 0,
              device=None):
    """(T, S) bool mask. `offset` = absolute position of query 0 minus
    key 0."""
    qi = torch.arange(t, device=device)[:, None] + offset
    kj = torch.arange(s, device=device)[None, :]
    m = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window:
        m &= kj > qi - window
    return m


def attn_forward(p: dict, cfg, x: torch.Tensor, cos, sin, *,
                 causal: bool = True, window: int = 0,
                 return_cache: bool = False, max_len: int = 0):
    """Full-sequence attention (train / prefill).

    Returns (y, cache|None). For prefill, `max_len` sizes the cache
    buffer (>= T for full attention; ring of size `window` for SWA).
    With cfg.q_chunk > 0 the scores are computed one query block at a
    time, bounding the live score tensor to B*H*q_chunk*T f32.
    """
    b, t, _ = x.shape
    hd = cfg.hd
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
    if cos is not None:
        q = layers.rope_apply(q, cos, sin)
        k = layers.rope_apply(k, cos, sin)
    scale = _scale(hd, x.device)
    q_chunk = getattr(cfg, "q_chunk", 0)
    use_flash = (getattr(cfg, "attention_impl", "xla") == "flash"
                 and window == 0 and causal and t % 64 == 0)
    if use_flash:
        # the wrapper asserts that T divides by its tiles: T % 64 == 0 here
        blk = 128 if t % 128 == 0 else 64
        out = flash_attn.gqa_flash(q, k, v, causal=True, blk_q=blk,
                                   blk_k=blk)
        y = out.reshape(b, t, cfg.num_heads * hd).to(x.dtype) @ p["wo"]
    elif q_chunk and t > q_chunk and t % q_chunk == 0:
        out = _chunked_attention(q, k, v, scale, causal, window, q_chunk)
        y = out.to(x.dtype) @ p["wo"]
    else:
        scores = _gqa_scores(q, k, scale)
        mask = full_mask(t, t, causal, window, device=x.device)
        probs = _masked_softmax(scores, mask)
        y = _gqa_out(probs, v).to(x.dtype) @ p["wo"]

    cache = None
    if return_cache:
        s = min(window, max_len) if window else max_len
        assert s > 0
        if window and t > s:
            # the ring keeps the trailing `window` positions, rotated so
            # that slot = pos % S matches decode-time writes
            shift = t % s
            ck = torch.roll(k[:, -s:], shift, dims=1)
            cv = torch.roll(v[:, -s:], shift, dims=1)
        else:
            ck = torch.zeros((b, s, cfg.num_kv_heads, hd), dtype=k.dtype,
                             device=k.device)
            cv = torch.zeros_like(ck, dtype=v.dtype)
            n = min(t, s)
            ck[:, :n] = k[:, -n:]
            cv[:, :n] = v[:, -n:]
        cache = {"k": ck, "v": cv}
    return y, cache


def attn_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: int, cos,
                sin, *, window: int = 0):
    """Single-token decode. x (B,1,d); pos: the absolute position (int).

    Writes the token's key and value into `cache` in place; returns
    (y, cache)."""
    hd = cfg.hd
    s = cache["k"].shape[1]
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
    if cos is not None:
        q = layers.rope_apply(q, cos, sin)
        k = layers.rope_apply(k, cos, sin)
    # the reference's dynamic_update_slice clamps the start into range
    slot = min(pos % s if window else pos, s - 1)
    ck, cv = cache["k"], cache["v"]
    ck[:, slot:slot + 1] = k
    cv[:, slot:slot + 1] = v

    scores = _gqa_scores(q, ck, _scale(hd, x.device))  # (B,G,Hg,1,S)
    idx = torch.arange(s, device=x.device)
    if window:
        valid = idx < min(pos + 1, s)  # ring: all that is written is in
    else:
        valid = idx <= pos
    probs = _masked_softmax(scores, valid[None, None, None, None, :])
    y = _gqa_out(probs, cv).to(x.dtype) @ p["wo"]
    return y, cache


def _chunked_attention(q, k, v, scale, causal, window, q_chunk):
    """Query-blocked attention: a loop over query chunks, full K/V
    visible. Returns (B, T, H*hd) f32."""
    b, t, h, hd = q.shape
    outs = []
    for i in range(t // q_chunk):
        qb = q[:, i * q_chunk:(i + 1) * q_chunk]
        scores = _gqa_scores(qb, k, scale)
        mask = full_mask(q_chunk, t, causal, window, offset=i * q_chunk,
                         device=q.device)
        outs.append(_gqa_out(_masked_softmax(scores, mask), v))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------- cross-attention


def cross_attn_init(cfg) -> dict:
    return attn_init(cfg)


def cross_attn_kv(p: dict, cfg, enc: torch.Tensor) -> dict:
    """The encoder's K/V, computed once at prefill and reused by every
    decode step: enc (B, S, d) -> {"k", "v"} (B, S, G, hd)."""
    hd = cfg.hd
    return {"k": _split_heads(enc @ p["wk"], cfg.num_kv_heads, hd),
            "v": _split_heads(enc @ p["wv"], cfg.num_kv_heads, hd)}


def cross_attn_apply(p: dict, cfg, x: torch.Tensor, kv: dict
                     ) -> torch.Tensor:
    """Non-causal attention of x (B, T, d) over all S encoder positions,
    no mask and no RoPE (the einsum path)."""
    hd = cfg.hd
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    scores = _gqa_scores(q, kv["k"], _scale(hd, x.device))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, kv["v"]).to(x.dtype) @ p["wo"]
