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
Inside a `tp.scope` train, prefill and decode run on this rank's heads
(`_tp_qkv`), and the cache holds this rank's KV heads where they divide
over "model", all of them where they do not. Where the scope puts the
cache's sequence on "data" (`tp.seq_over_data`), a rank's cache holds a
block of the positions: the prefill stores those, a decode step writes
the token's key and value on the rank that owns its slot, and the
ranks' partial softmaxes are combined (`tp.combine_over_data`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attn
from repro_torch.models import layers, tp

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


def _scale(hd: int) -> float:
    """1 / sqrt(hd) computed in f32, as the reference does: an f32 value
    as a Python float, so that no tensor is built from a host value (no
    host-to-device copy a call, and it works on the meta device under
    `torch.func.grad`)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


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
    if tp.active() is not None:
        # k, v hold the heads the cache holds; `pick` gives the q heads'
        q, ck, cv, out_proj, pick = _tp_qkv(p, cfg, x, cos, sin)
        k, v = pick(ck), pick(cv)
    else:
        q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
        k = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
        v = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
        if cos is not None:
            q = layers.rope_apply(q, cos, sin)
            k = layers.rope_apply(k, cos, sin)
        ck, cv = k, v

        def out_proj(out):
            return out @ p["wo"]
    scale = _scale(hd)
    q_chunk = getattr(cfg, "q_chunk", 0)
    use_flash = (getattr(cfg, "attention_impl", "xla") == "flash"
                 and window == 0 and causal and t % 64 == 0)
    if use_flash:
        # the wrapper asserts that T divides by its tiles: T % 64 == 0 here
        blk = 128 if t % 128 == 0 else 64
        out = flash_attn.gqa_flash(q, k, v, causal=True, blk_q=blk,
                                   blk_k=blk)
        y = out_proj(out.reshape(b, t, q.shape[2] * hd).to(x.dtype))
    elif q_chunk and t > q_chunk and t % q_chunk == 0:
        out = _chunked_attention(q, k, v, scale, causal, window, q_chunk)
        y = out_proj(out.to(x.dtype))
    else:
        scores = _gqa_scores(q, k, scale)
        mask = full_mask(t, t, causal, window, device=x.device)
        probs = _masked_softmax(scores, mask)
        y = out_proj(_gqa_out(probs, v).to(x.dtype))

    cache = None
    if return_cache:
        # the KV heads the cache holds: every one, or inside a tp.scope
        # this rank's block of them where they divide over "model"
        s = min(window, max_len) if window else max_len
        assert s > 0
        if window and t > s:
            # the ring keeps the trailing `window` positions, rotated so
            # that slot = pos % S matches decode-time writes
            shift = t % s
            kc = torch.roll(ck[:, -s:], shift, dims=1)
            vc = torch.roll(cv[:, -s:], shift, dims=1)
        else:
            kc = torch.zeros((b, s) + tuple(ck.shape[2:]), dtype=ck.dtype,
                             device=ck.device)
            vc = torch.zeros_like(kc, dtype=cv.dtype)
            n = min(t, s)
            kc[:, :n] = ck[:, -n:]
            vc[:, :n] = cv[:, -n:]
        cache = {"k": tp.own_positions(kc), "v": tp.own_positions(vc)}
    return y, cache


def _tp_qkv(p: dict, cfg, x: torch.Tensor, cos, sin):
    """q, the k and v of the KV heads this rank's cache holds, the output
    projection, and `pick`, which maps those k or v to the KV heads this
    rank's q heads read: tensor-parallel attention (inside a
    `tp.scope`), each projection's split read from its width.

    Where the q blocks hold whole heads (H % M == 0), attention runs on
    this rank's H/M heads: `wq` column-parallel; `wk` / `wv` too where
    their blocks hold whole KV heads (G % M == 0), else (gemma's one KV
    head, whose head_dim the rules split over M = 2) their output is
    gathered over "model" (or computed whole from a replicated leaf) and
    this rank's q heads read the KV heads they group with; `wo`
    row-parallel, its partial product summed over "model". Where the q
    blocks do not hold whole heads (H = 12 on M = 8), every projection's
    output is gathered (GSPMD pays a collective there too), attention
    runs on all heads on every rank, and `wo` reads this rank's rows of
    its output. RoPE acts on whole heads: it rotates after a gather. A
    replicated tensor that feeds a rank's own blocks passes
    `tp.copy_to_model`, so its cotangent is summed over the ranks.

    The cache holds the KV heads the reference's cache rules give the
    rank (`sharding.cache_pspecs`): its G/M heads where G % M == 0, else
    all G."""
    hd, nh, ng = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    m, j = tp.model_size(), tp.model_index()
    xc = tp.copy_to_model(x)

    def whole(w, n):
        """The projection's output over all n heads, replicated."""
        if tp.split(w.shape[-1], n * hd) == 1:
            return _split_heads(x @ w, n, hd)
        return _split_heads(tp.gather_from_model(xc @ w, -1), n, hd)

    def rope(z):
        return z if cos is None else layers.rope_apply(z, cos, sin)

    def same(z):
        return z

    local_q = tp.split(p["wq"].shape[-1], nh * hd) > 1 and nh % m == 0
    pick = same
    if local_q:
        hq = nh // m
        q = rope(_split_heads(xc @ p["wq"], hq, hd))
        if tp.split(p["wk"].shape[-1], ng * hd) > 1 and ng % m == 0:
            k = rope(_split_heads(xc @ p["wk"], ng // m, hd))
            v = _split_heads(xc @ p["wv"], ng // m, hd)
        else:
            k, v = (tp.copy_to_model(z) for z in (
                rope(whole(p["wk"], ng)), whole(p["wv"], ng)))
            if ng % m == 0:  # a replicated leaf: the rank's KV heads
                k, v = (z.narrow(2, j * (ng // m), ng // m) for z in (k, v))
            else:
                def pick(z):
                    return _kv_for_heads(z, j * hq, hq, nh // ng)
    else:
        q, k, v = (rope(whole(p["wq"], nh)), rope(whole(p["wk"], ng)),
                   whole(p["wv"], ng))
    wo = p["wo"]
    rows = wo.shape[0]
    if tp.split(rows, nh * hd) == 1:
        def out_proj(out):
            if local_q:
                out = tp.gather_from_model(out, -1)
            return out @ wo
    else:
        def out_proj(out):
            if not local_q:
                out = tp.copy_to_model(out).narrow(-1, j * rows, rows)
            return tp.reduce_from_model(out @ wo)
    return q, k, v, out_proj, pick


def _kv_for_heads(z: torch.Tensor, first: int, count: int,
                  group: int) -> torch.Tensor:
    """The KV heads of z (B, T, G, hd) that q heads first .. first +
    count - 1 read (q head h reads KV head h // group), laid out so that
    the GQA kernels' own grouping pairs them: the span of KV heads when
    each holds the same number of those q heads, else one KV head per q
    head."""
    idx = [(first + i) // group for i in range(count)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if count % n == 0 and idx == [lo + i // (count // n)
                                  for i in range(count)]:
        return z[:, :, lo:lo + n]
    return z[:, :, idx]


def attn_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: int, cos,
                sin, *, window: int = 0):
    """Single-token decode. x (B,1,d); pos: the absolute position (int).

    Writes the token's key and value into `cache` in place; returns
    (y, cache)."""
    hd = cfg.hd
    s = cache["k"].shape[1]
    if tp.active() is not None:
        # the cache holds the KV heads of `_tp_qkv`'s k and v
        q, k, v, out_proj, pick = _tp_qkv(p, cfg, x, cos, sin)
    else:
        q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
        k = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
        v = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
        if cos is not None:
            q = layers.rope_apply(q, cos, sin)
            k = layers.rope_apply(k, cos, sin)

        def out_proj(out):
            return out @ p["wo"]

        def pick(z):
            return z
    # the reference's dynamic_update_slice clamps the start into range;
    # where the sequence is on "data" the rank holds positions lo ..
    # lo + s - 1 of the whole ring or buffer and writes the slot it owns
    lo, whole = tp.seq_block(s), s * tp.seq_blocks()
    slot = min(pos % whole if window else pos, whole - 1) - lo
    ck, cv = cache["k"], cache["v"]
    if 0 <= slot < s:
        ck[:, slot:slot + 1] = k
        cv[:, slot:slot + 1] = v

    scores = _gqa_scores(q, pick(ck), _scale(hd))  # (B,G,Hg,1,S)
    idx = torch.arange(lo, lo + s, device=x.device)
    if window:
        valid = idx < min(pos + 1, whole)  # ring: all that is written is in
    else:
        valid = idx <= pos
    if tp.seq_over_data() is None:
        probs = _masked_softmax(scores, valid[None, None, None, None, :])
        return out_proj(_gqa_out(probs, pick(cv)).to(x.dtype)), cache
    out, sums = tp.combine_over_data(scores, valid,
                                     lambda p_: _gqa_out(p_, pick(cv)))
    b, g, hg = sums.shape[:3]  # sums (B, G, Hg, 1), out (B, 1, H * hd)
    out = out.reshape(b, 1, g, hg, -1) / sums.permute(0, 3, 1, 2)[..., None]
    return out_proj(out.reshape(b, 1, -1).to(x.dtype)), cache


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
    scores = _gqa_scores(q, kv["k"], _scale(hd))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, kv["v"]).to(x.dtype) @ p["wo"]
