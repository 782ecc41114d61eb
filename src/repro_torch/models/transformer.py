"""Unified architecture assembly for the model zoo: the counterpart of
`repro/models/transformer.py`, for every family of the registry (dense
GQA / MQA, MoE with MLA, the Jamba Mamba + attention hybrid, RWKV-6, the
Whisper encoder-decoder and Qwen2-VL's M-RoPE language backbone).

A model is `cfg.num_pattern_groups` groups of `len(cfg.block_pattern)`
blocks; block params are stacked over groups with a leading axis exactly
as in the reference, so weights carry across as plain copies
(`convert.lm_params_from_numpy`). The stack runs as a Python loop over
groups (the reference scans), and the prefill cache is stacked over
groups as the reference's scan stacks it.

Block kinds: "attn" (GQA / MQA or MLA; + cross-attention for enc-dec),
"mamba", "rwkv". Every non-rwkv block has an FFN slot (dense MLP or MoE
by cfg.moe_pattern); rwkv blocks embed their own channel mix.

Entry points:
  forward(..., mode="train")    -> (logits, aux, text_offset)
  forward(..., mode="prefill")  -> (logits, aux, cache)
  decode_step(...)              -> (logits, cache)   # one token
  loss_fn(params, cfg, batch)   -> scalar f32 next-token CE + MoE aux
  hidden_forward(...)           -> (x, aux, text_offset) before unembed

`decode_step` writes into `cache` in place (the reference returns an
updated copy) and returns it. `init_params` allocates every stacked leaf
once, in its dtype, and fills it group by group and expert by expert
(`layers.make`), so that the transient of an init is one draw of at most
256 MiB in f32, not a second copy of the model.

`loss_fn` is what federated LM training differentiates (under
`torch.func.vmap(grad)` in the round); with `cfg.attention_impl ==
"flash"` its attention runs the flash kernel, whose backward is the
reference's recompute. In training mode each group of blocks runs under
`recompute.recompute`, as the reference wraps its scanned group body in
`jax.checkpoint`: the backward keeps one residual stream a group and
runs the group again. With `cfg.loss_chunk` the unembed and the
cross-entropy run chunk by chunk over tokens (`_chunked_ce`), with the
reference's padding and masking, each chunk recomputed in the backward
as the reference's `jax.checkpoint(chunk)` is, so a chunk's (B, L, V)
logits are never kept.

Inside an FSDP scope (`tp.scope(..., specs=)`, the params in blocks on
both axes) each group's leaves are gathered over "data" where the group
runs and let go after it (`tp.gather_params`): in training inside the
group's recompute, so that the backward's rerun gathers them again; the
embedding, the head and the final norm are gathered at their use (a
tied embedding once). With the rows split over "data" the loss is that
of every data index's rows (`tp.rows_mean`).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.core import treemath
from repro_torch.models import (
    attention,
    layers,
    mamba,
    mla,
    moe,
    recompute,
    rwkv6,
    sharding,
    tp,
)
from repro_torch.models.config import ModelConfig

Tree = Any


# =================================================================== init


def _ffn_init(cfg, is_moe: bool) -> dict:
    if is_moe:
        return moe.moe_init(cfg)
    return layers.mlp_init(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.tdtype)


def _block_init(cfg, kind: str, is_moe: bool, cross: bool) -> dict:
    d, dt = cfg.d_model, cfg.tdtype
    p: dict = {"norm1": layers.norm_init(d, cfg.norm, dt)}
    if kind == "attn":
        p["mixer"] = (mla.mla_init(cfg) if cfg.mla
                      else attention.attn_init(cfg))
    elif kind == "mamba":
        p["mixer"] = mamba.mamba_init(cfg)
    elif kind == "rwkv":
        p["mixer"] = rwkv6.rwkv_init(cfg)
        p["norm2"] = layers.norm_init(d, cfg.norm, dt)
        return p  # the rwkv block embeds its channel mix: no FFN slot
    else:
        raise ValueError(kind)
    if cross:
        p["norm_cross"] = layers.norm_init(d, cfg.norm, dt)
        p["cross"] = attention.cross_attn_init(cfg)
    p["norm2"] = layers.norm_init(d, cfg.norm, dt)
    p["ffn"] = _ffn_init(cfg, is_moe)
    return p


def _stack_init(cfg, *, cross: bool, num_groups: int) -> dict:
    """Stacked block params: {"p{i}": leaves with a leading group axis}."""
    return {f"p{i}": layers.stacked(num_groups,
                                    _block_init(cfg, kind, is_moe, cross))
            for i, (kind, is_moe) in enumerate(cfg.layer_kinds())}


def _param_inits(cfg: ModelConfig) -> Tree:
    """The params of `cfg` as a tree of `layers.Init`s."""
    dt = cfg.tdtype
    params = {
        "embed": layers.embed_init(cfg.vocab_size, cfg.d_model, dt),
        "blocks": _stack_init(cfg, cross=cfg.encoder_layers > 0,
                              num_groups=cfg.num_pattern_groups),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(cfg.d_model, cfg.vocab_size,
                                              dt)
    if cfg.encoder_layers:
        # the encoder is a plain full-attention stack, one group a layer
        params["encoder"] = {
            "blocks": _stack_init(cfg, cross=False,
                                  num_groups=cfg.encoder_layers),
            "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dt),
        }
    return params


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None, *, mesh=None, specs=None) -> Tree:
    """Random params of `cfg` from `gen`, on `device` (default: the
    generator's). On the "meta" device nothing is allocated and `gen`
    may be None. The draws differ from the reference's (another RNG);
    the layout, the dtypes and the distributions are its.

    Given a `ClientMesh` and the spec tree of the params
    (`sharding.param_pspecs`), this rank's blocks: bit for bit
    `sharding.shard_params(init_params(gen, cfg), mesh, specs)`, made
    leaf by leaf (each leaf whole, cut, and freed before the next), so
    that no process holds the whole model."""
    device = torch.device(device if device is not None else gen.device)
    cut = None
    if mesh is not None:
        def cut(keys, x):
            return sharding.block(x, mesh, sharding.spec_at(specs, keys))
    return layers.make(_param_inits(cfg), gen, device, cut)


# ============================================================ positions


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Additive sinusoidal embedding (whisper-style positions)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _rope_for(cfg, batch, b: int, t: int, offset: int = 0, device=None):
    """cos/sin (B, T, hd/2) for the configured rope style, at positions
    offset .. offset + T - 1 (M-RoPE: `batch["positions"]` (3, B, T)
    when given); (None, None) for rope_style "none". MLA rotates at its
    rope_head_dim."""
    hd = cfg.mla.rope_head_dim if cfg.mla else cfg.hd
    if cfg.rope_style == "none":
        return None, None
    pos = (torch.arange(t, device=device)[None] + offset).repeat(b, 1)
    if cfg.rope_style == "mrope":
        if batch.get("positions") is not None:
            pos = batch["positions"]
        else:
            pos = pos[None].expand(3, b, t)
        return layers.mrope_cos_sin(pos, hd, cfg.rope_theta,
                                    cfg.mrope_sections)
    return layers.rope_cos_sin(pos, hd, cfg.rope_theta)


# =============================================================== blocks


def _write(cache: dict, state: dict) -> dict:
    """Copy a recurrent layer's new state into its cache slice."""
    for k, v in state.items():
        cache[k].copy_(v)
    return cache


def _mixer(bp, cfg, kind, x, ctx, cache, mode):
    """Dispatch one mixer. Returns (y, new_cache_or_None)."""
    cos, sin = ctx["cos"], ctx["sin"]
    if kind == "attn":
        if cfg.mla:
            if mode == "decode":
                return mla.mla_decode(bp["mixer"], cfg, x, cache,
                                      ctx["pos"], cos, sin)
            return mla.mla_forward(bp["mixer"], cfg, x, cos, sin,
                                   return_cache=(mode == "prefill"),
                                   max_len=ctx["max_len"])
        if mode == "decode":
            return attention.attn_decode(bp["mixer"], cfg, x, cache,
                                         ctx["pos"], cos, sin,
                                         window=ctx["window"])
        return attention.attn_forward(
            bp["mixer"], cfg, x, cos, sin, causal=True,
            window=ctx["window"], return_cache=(mode == "prefill"),
            max_len=ctx["max_len"] if mode == "prefill" else 0)
    if kind == "mamba":
        y, state = mamba.mamba_forward(bp["mixer"], cfg, x,
                                       cache if mode == "decode" else None)
        if mode == "decode":
            return y, _write(cache, state)
        return y, (state if mode == "prefill" else None)
    raise ValueError(kind)


def _block(bp, cfg, kind, is_moe, x, ctx, cache, mode):
    """One block. Returns (x, new_cache, aux)."""
    aux = None
    h = layers.norm_apply(bp["norm1"], x)
    if kind == "rwkv":
        if mode == "decode":
            y, tm = rwkv6.time_mix_decode(bp["mixer"], cfg, h, cache)
        else:
            y, tm = rwkv6.time_mix(bp["mixer"], cfg, h, None)
        x = x + y
        # rwkv: the channel mix lives inside the block (own token shift)
        h2 = layers.norm_apply(bp["norm2"], x)
        y2, cm = rwkv6.channel_mix(
            bp["mixer"], h2, cache["cm_last"] if mode == "decode" else None)
        x = x + y2
        new_cache = None
        if mode == "prefill":
            new_cache = dict(tm, cm_last=cm)
        elif mode == "decode":
            new_cache = _write(cache, dict(tm, cm_last=cm))
        return x, new_cache, aux

    y, new_cache = _mixer(bp, cfg, kind, h, ctx, cache, mode)
    x = x + y
    if "cross" in bp:
        hc = layers.norm_apply(bp["norm_cross"], x)
        if mode == "decode":
            kv = {"k": cache["cross_k"], "v": cache["cross_v"]}
        else:
            kv = attention.cross_attn_kv(bp["cross"], cfg, ctx["enc"])
        x = x + attention.cross_attn_apply(bp["cross"], cfg, hc, kv)
        if mode == "prefill":
            new_cache = dict(new_cache or {}, cross_k=kv["k"],
                             cross_v=kv["v"])
    hf = layers.norm_apply(bp["norm2"], x)
    if is_moe:
        yf, aux = moe.moe_apply(bp["ffn"], cfg, hf)
    else:
        yf = layers.mlp_apply(bp["ffn"], hf, cfg.mlp, cfg.d_ff)
    return x + yf, new_cache, aux


def _encoder_block(bp, cfg, x):
    """One encoder block: non-causal self-attention with no RoPE (the
    einsum path: flash is causal only), then the MLP."""
    h = layers.norm_apply(bp["norm1"], x)
    y, _ = attention.attn_forward(bp["mixer"], cfg, h, None, None,
                                  causal=False)
    x = x + y
    hf = layers.norm_apply(bp["norm2"], x)
    return x + layers.mlp_apply(bp["ffn"], hf, cfg.mlp)


def _run_stack(blocks, cfg, x, ctx, mode, cache=None, *, encoder=False):
    """Run the stacked groups in order. Returns (x, aux, cache|None): aux
    sums the MoE blocks' load-balance losses; prefill returns a new cache
    stacked over groups; decode writes into `cache` in place and returns
    it. In training mode each group is recomputed in the backward
    (`_train_group`)."""
    kinds = (("attn", False),) if encoder else cfg.layer_kinds()
    groups = cfg.encoder_layers if encoder else cfg.num_pattern_groups
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {f"p{i}": [] for i in range(len(kinds))}
    specs = _group_specs(len(kinds), encoder)
    for gi in range(groups):
        subs = [_index(blocks[f"p{i}"], gi) for i in range(len(kinds))]
        if mode == "train":
            x, aux = _train_group(subs, cfg, kinds, x, aux, ctx, encoder,
                                  specs)
            continue
        # FSDP: the group's leaves whole over "data" while it runs only
        subs = [tp.gather_params(sub, spec, lead=1)
                for sub, spec in zip(subs, specs)]
        for i, (kind, is_moe) in enumerate(kinds):
            c_in = _index(cache[f"p{i}"], gi) if mode == "decode" else None
            x, nc, a = _block(subs[i], cfg, kind, is_moe, x, ctx, c_in, mode)
            if a is not None:
                aux = aux + a
            if mode == "prefill":
                caches[f"p{i}"].append(nc)
        del subs
    if mode == "prefill":
        cache = {k: _stack(v) for k, v in caches.items()}
    return x, aux, cache if mode in ("prefill", "decode") else None


_CTX_TENSORS = ("cos", "sin", "enc")  # the tensors of ctx a block reads


def _group_specs(n: int, encoder: bool) -> list:
    """Each block position's part of the scope's UNSTACKED spec tree
    under "blocks" inside an FSDP scope (`tp.param_specs`), else Nones."""
    specs = tp.param_specs()
    if specs is None or encoder:
        return [None] * n
    return [specs["blocks"][f"p{i}"] for i in range(n)]


def _train_group(subs, cfg, kinds, x, aux, ctx, encoder, specs):
    """One group of blocks in training mode, (x, aux) -> (x, aux), under
    `recompute.recompute`: the group's params, its input and ctx's
    tensors are the Function's arguments, so the backward keeps only
    them and runs the group again. Inside an FSDP scope the arguments
    are the rank's blocks, gathered over "data" inside the group: the
    backward's rerun gathers them again, so no more than one group is
    ever whole."""
    flat = [treemath.tree_flatten(sub) for sub in subs]
    sizes = [len(lv) for lv, _ in flat]
    present = [name for name in _CTX_TENSORS if ctx.get(name) is not None]

    def group(x, aux, *rest):
        gctx = dict(ctx, **dict(zip(present, rest)))
        leaves = rest[len(present):]
        for i, (kind, is_moe) in enumerate(kinds):
            sub = tp.gather_params(
                treemath.tree_unflatten(flat[i][1], leaves[:sizes[i]]),
                specs[i], lead=1)
            leaves = leaves[sizes[i]:]
            if encoder:
                x = _encoder_block(sub, cfg, x)
                continue
            x, _, a = _block(sub, cfg, kind, is_moe, x, gctx, None, "train")
            if a is not None:
                aux = aux + a
        return x, aux

    return recompute.recompute(group, x, aux,
                               *(ctx[name] for name in present),
                               *(leaf for lv, _ in flat for leaf in lv))


def _stack(trees: list) -> Tree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ================================================================ public


def _embed(table, cfg, tokens):
    """The rows of `tokens` in the embedding. Inside a `tp.scope` a table
    split on the vocab is looked up vocab-parallel (ids outside this
    rank's block give zero rows, summed over "model"), one split on
    d_model gathers its columns."""
    vocab, width = table.shape
    start = tp.vocab_start(vocab, cfg.vocab_size)
    if start is not None:
        ids = tokens - start
        inside = (ids >= 0) & (ids < vocab)
        rows = table[torch.where(inside, ids, 0)]
        return tp.reduce_from_model(torch.where(
            inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                 device=rows.device)))
    if tp.split(width, cfg.d_model) > 1:
        return tp.gather_from_model(table[tokens], -1)
    return table[tokens]


def _whole(params, name: str):
    """The top-level leaf (or subtree) `name` whole over "data" inside an
    FSDP scope (`tp.gather_params` on its part of the scope's spec
    tree), as it is otherwise: gathered at its use."""
    specs = tp.param_specs()
    if specs is None:
        return params[name]
    return tp.gather_params(params[name], specs[name])


def embed_inputs(params, cfg, batch):
    """Token embedding and the stub multimodal prefix: the (B, P, d)
    `batch["vision_embeds"]` go before the text. Returns (x,
    text_offset): the loss applies from text_offset onward."""
    return _embed_inputs(_whole(params, "embed"), cfg, batch)


def _embed_inputs(table, cfg, batch):
    x = _embed(table, cfg, batch["tokens"])
    offset = 0
    if cfg.vision_prefix:
        v = batch["vision_embeds"].to(x.dtype)  # (B, P, d) stub patches
        x = torch.cat([v, x], dim=1)
        offset = v.shape[1]
    return x, offset


def _prologue(params, cfg, batch, table):
    """The embedded inputs (`table`: the embedding, whole over "data")
    with their positions, and the encoder's output for enc-dec models.
    Returns (x, text_offset, ctx)."""
    tp.check_supported(cfg)
    x, text_offset = _embed_inputs(table, cfg, batch)
    b, t = x.shape[0], x.shape[1]
    cos, sin = _rope_for(cfg, batch, b, t, device=x.device)
    if cfg.rope_style == "none":
        x = x + _sinusoid(torch.arange(t, device=x.device),
                          cfg.d_model).to(x.dtype)[None]
    enc = None
    if cfg.encoder_layers:
        enc = batch["enc_embeds"].to(x.dtype)  # stub frame embeddings
        enc, _, _ = _run_stack(params["encoder"]["blocks"], cfg, enc, {},
                               "train", encoder=True)
        enc = layers.norm_apply(params["encoder"]["final_norm"], enc)
    ctx = {"cos": cos, "sin": sin, "pos": None,
           "window": cfg.sliding_window, "enc": enc, "max_len": t}
    return x, text_offset, ctx


def _stack_run(params, cfg, batch, mode: str, max_len: int = 0):
    """Embedding, the stack and the final norm: (x, aux, text_offset or
    cache, table). The embedding is gathered over "data" once (FSDP) and
    let go before the stack, unless the head reuses it (tied): `table`
    is then that gathered table, else None."""
    table = _whole(params, "embed")
    x, text_offset, ctx = _prologue(params, cfg, batch, table)
    if not cfg.tie_embeddings:
        table = None
    ctx["max_len"] = max(max_len, x.shape[1])
    x, aux, cache = _run_stack(params["blocks"], cfg, x, ctx, mode)
    x = layers.norm_apply(_whole(params, "final_norm"), x)
    return x, aux, cache if mode == "prefill" else text_offset, table


def forward(params, cfg: ModelConfig, batch, *, mode: str = "train",
            max_len: int = 0):
    """Full-sequence forward. mode: "train" | "prefill". Inside a
    `tp.scope` the logits are this rank's vocab block where the head is
    split on the vocab (`tp.gather_logits` joins the positions a caller
    reads), and the prefill cache holds this rank's blocks
    (`sharding.cache_pspecs`)."""
    if mode not in ("train", "prefill"):
        raise ValueError(mode)
    x, aux, extra, table = _stack_run(params, cfg, batch, mode, max_len)
    # inside a tp.scope this rank's vocab block of the logits
    logits = _head_logits(*_head(params, cfg, table), x)
    return logits, aux, extra


def unembed(params, cfg, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _head(params, cfg, table=None):
    """The unembedding as a (d, V) matrix view and the dims of it this
    rank holds a block of: (w, vocab block start or None, d split).
    Tied, `table` is the embedding already gathered over "data" (FSDP);
    otherwise the head is gathered here."""
    if cfg.tie_embeddings:
        w = (_whole(params, "embed") if table is None else table).T
    else:
        w = _whole(params, "lm_head")
    return (w, tp.vocab_start(w.shape[1], cfg.vocab_size),
            tp.split(w.shape[0], cfg.d_model) > 1)


def _head_logits(w, vocab_start, d_split, x):
    """x @ w in training. Inside a `tp.scope`, with w split on the vocab
    this rank's block of the logits (x read through `copy_to_model`); split
    on d_model the partial products over this rank's rows, summed over
    "model". Whole, the whole logits."""
    if vocab_start is not None:
        return tp.copy_to_model(x) @ w
    if d_split:
        rows = w.shape[0]
        part = tp.copy_to_model(x).narrow(-1, tp.block_start(rows), rows)
        return tp.reduce_from_model(part @ w)
    return x @ w


def hidden_forward(params, cfg: ModelConfig, batch):
    """Forward up to the final norm, WITHOUT the unembed projection.
    Returns (x, aux, text_offset)."""
    return _stack_run(params, cfg, batch, "train")[:3]


def _chunked_ce(params, cfg, x_pred, labels, table=None):
    """Cross-entropy with the unembed applied chunk by chunk over tokens
    (cfg.loss_chunk): x_pred (B, T, d), labels (B, T). T is padded to a
    multiple of the chunk with zero rows and labels, masked out of the
    mean, as the reference does. Each chunk runs under
    `recompute.recompute`, as the reference's `jax.checkpoint(chunk)`:
    its (B, L, V) logits are recomputed in the backward, never kept.
    Returns (the summed losses, the token count); `table` as `_head`'s
    (the head reaches every chunk gathered)."""
    b, t, d = x_pred.shape
    size = cfg.loss_chunk
    pad = (-t) % size
    mask = torch.cat([torch.ones((b, t), dtype=torch.float32,
                                 device=x_pred.device),
                      torch.zeros((b, pad), dtype=torch.float32,
                                  device=x_pred.device)], 1)
    if pad:
        x_pred = torch.cat([x_pred, x_pred.new_zeros((b, pad, d))], 1)
        labels = torch.cat([labels, labels.new_zeros((b, pad))], 1)
    w, start, d_split = _head(params, cfg, table)
    if cfg.tie_embeddings:
        w = w.T  # the (V, d) table: each chunk transposes it

    def chunk(w, xc, yc, mc):
        logits = _head_logits(w.T if cfg.tie_embeddings else w, start,
                              d_split, xc)
        return (torch.sum(layers.token_nll(logits, yc, start) * mc),)

    total = torch.zeros((), dtype=torch.float32, device=x_pred.device)
    for i in range(0, t + pad, size):
        xc, yc, mc = (z[:, i:i + size] for z in (x_pred, labels, mask))
        total = total + recompute.recompute(chunk, w, xc, yc, mc)[0]
    return total, torch.sum(mask)


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy plus the MoE aux loss: predict
    tokens[1:] from the positions [off .. off + T - 2], where off is the
    vision prefix's length. `batch["loss_mask"]`, when given, weights the
    tokens (not with `cfg.loss_chunk`, as in the reference). Returns a
    scalar f32. Inside a scope that splits the rows over "data" (the
    FSDP sequential round) it is the loss over every data index's rows,
    the same on every rank (`tp.rows_mean`)."""
    tokens = batch["tokens"]
    x, aux, off, table = _stack_run(params, cfg, batch, "train")
    if cfg.loss_chunk:
        x_pred = x[:, off:-1] if off else x[:, :-1]
        total, count = _chunked_ce(params, cfg, x_pred, tokens[:, 1:],
                                   table)
        return tp.rows_mean(total, count, aux)
    # inside a tp.scope the logits of this rank's vocab block (or the
    # whole logits of a head split on d_model)
    w, start, d_split = _head(params, cfg, table)
    logits = _head_logits(w, start, d_split, x)
    pred = logits[:, off:-1] if off else logits[:, :-1]
    if tp.rows_over_data() is None:
        ce = layers.softmax_cross_entropy(pred, tokens[:, 1:],
                                          batch.get("loss_mask"),
                                          vocab_start=start)
        return ce + aux
    nll = layers.token_nll(pred, tokens[:, 1:], start)
    mask = batch.get("loss_mask")
    if mask is None:
        return tp.rows_mean(torch.sum(nll), torch.full(
            (), float(nll.numel()), device=nll.device), aux)
    m = mask.to(torch.float32)
    return tp.rows_mean(torch.sum(nll * m), torch.sum(m), aux)


def decode_step(params, cfg: ModelConfig, token, cache, pos: int,
                batch_extras=None):
    """One-token decode. token (B,1) int; pos the absolute position;
    `batch_extras` may hold M-RoPE `positions` (3, B, 1).

    Returns (logits (B,1,V), cache): the token's keys and values (or
    latents, or recurrent state) are written into `cache` in place.
    Inside a `tp.scope` the cache is this rank's blocks and the logits
    its vocab block, as `forward`'s."""
    pos = int(pos)
    tp.check_supported(cfg)
    table = _whole(params, "embed")
    x = _embed(table, cfg, token)
    if not cfg.tie_embeddings:
        table = None  # let it go before the stack
    if cfg.rope_style == "none":
        x = x + _sinusoid(torch.arange(pos, pos + 1, device=x.device),
                          cfg.d_model).to(x.dtype)[None]
        cos = sin = None
    else:
        cos, sin = _rope_for(cfg, batch_extras or {}, x.shape[0], 1,
                             offset=pos, device=x.device)
    ctx = {"cos": cos, "sin": sin, "pos": pos,
           "window": cfg.sliding_window, "enc": None, "max_len": 0}
    x, _, cache = _run_stack(params["blocks"], cfg, x, ctx, "decode", cache)
    x = layers.norm_apply(_whole(params, "final_norm"), x)
    return _head_logits(*_head(params, cfg, table), x), cache


def init_cache(cfg: ModelConfig, b: int, max_len: int,
               device=None, *, mesh=None) -> Tree:
    """Zero-initialised decode cache (leaves stacked over groups): K/V
    (ring of the window for SWA), MLA latents, Mamba {h, conv}, RWKV
    {S, tm_last, cm_last}, and the cross K/V of enc-dec models. `b` is
    the global batch. Given a `ClientMesh`, this rank's blocks of it
    under `sharding.cache_pspecs`, each of its shard shape."""
    if mesh is not None:
        shapes = init_cache(cfg, b, max_len, device="meta")
        specs = sharding.cache_pspecs(shapes, mesh)
        return sharding.map_leaves(
            lambda keys, x: torch.zeros(
                sharding.NamedSpec(mesh, sharding.spec_at(specs, keys))
                .shard_shape(tuple(x.shape)), dtype=x.dtype,
                device=device), shapes)
    g = cfg.num_pattern_groups
    s = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len

    def zeros(shape, dtype=cfg.tdtype):
        return torch.zeros((g,) + tuple(shape), dtype=dtype, device=device)

    out = {}
    for i, (kind, _) in enumerate(cfg.layer_kinds()):
        if kind == "attn":
            if cfg.mla:
                m = cfg.mla
                c = {"ckv": zeros((b, max_len, m.kv_lora_rank)),
                     "krope": zeros((b, max_len, m.rope_head_dim))}
            else:
                c = {"k": zeros((b, s, cfg.num_kv_heads, cfg.hd)),
                     "v": zeros((b, s, cfg.num_kv_heads, cfg.hd))}
            if cfg.encoder_layers:
                shape = (b, cfg.encoder_len, cfg.num_kv_heads, cfg.hd)
                c["cross_k"], c["cross_v"] = zeros(shape), zeros(shape)
        elif kind in ("mamba", "rwkv"):
            mod = mamba if kind == "mamba" else rwkv6
            c = {k: zeros(v.shape, v.dtype)
                 for k, v in mod.init_state(cfg, b, device="meta").items()}
        else:
            raise ValueError(kind)
        out[f"p{i}"] = c
    return out


# ========================================================== param count


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the shapes of `init_params` on the meta
    device (nothing is allocated). With `active_only`, each
    routed-expert leaf (ndim 4: group, expert, in, out) counts top_k / E
    of its size."""
    shapes = init_params(None, cfg, device="meta")
    total = 0
    for path, leaf in zip(treemath.tree_paths(shapes),
                          treemath.tree_leaves(shapes)):
        n = leaf.numel()
        if (active_only and cfg.moe is not None and "ffn" in path
                and path[-1] in ("w_gate", "w_up", "w_down")
                and leaf.ndim == 4):
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total
