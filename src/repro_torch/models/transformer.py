"""Dense decoder-only transformer: the counterpart of
`repro/models/transformer.py` for the `dense` family (gemma-2b,
granite-20b, minitron-4b, starcoder2-15b).

A model is `cfg.num_pattern_groups` groups of `len(cfg.block_pattern)`
"attn" blocks; block params are stacked over groups with a leading axis
exactly as in the reference, so weights carry across as plain copies
(`convert.lm_params_from_numpy`). The stack runs as a Python loop over
groups (the reference scans), and the prefill cache is stacked over
groups as the reference's scan stacks it.

Entry points:
  forward(..., mode="train")    -> (logits, aux, text_offset)
  forward(..., mode="prefill")  -> (logits, aux, cache)
  decode_step(...)              -> (logits, cache)   # one token

Configs of the other families (MoE, MLA, SSM, RWKV, hybrid, enc-dec,
VLM prefixes, M-RoPE or no RoPE) raise NotImplementedError naming the
ROADMAP item that brings them. The loss, `hidden_forward` and the
chunked cross-entropy come with the training slice.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig

Tree = Any

_NOT_YET = ("ROADMAP Queue 1 item 15 (MoE / MLA / SSM / RWKV / hybrid / "
            "audio / VLM families)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config outside the dense family."""
    found = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("ssm", cfg.ssm is not None), ("rwkv", cfg.rwkv is not None),
        ("encoder_layers", cfg.encoder_layers > 0),
        ("vision_prefix", cfg.vision_prefix > 0),
        (f"rope_style={cfg.rope_style!r}", cfg.rope_style != "rope"),
        (f"block_pattern={cfg.block_pattern}",
         any(k != "attn" for k in cfg.block_pattern))) if on]
    if found:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(found)} is not ported yet; the port "
            f"runs the dense family so far. It comes with {_NOT_YET}.")


# =================================================================== init


def _block_init(gen, cfg, device) -> dict:
    d = cfg.d_model
    return {
        "norm1": layers.norm_init(d, cfg.norm, cfg.tdtype, device),
        "mixer": attention.attn_init(gen, cfg, device),
        "norm2": layers.norm_init(d, cfg.norm, cfg.tdtype, device),
        "ffn": layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp, cfg.tdtype,
                               device),
    }


def _stack(trees: list) -> Tree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_init(gen, cfg, device, *, num_groups: int) -> dict:
    """Stacked block params: {"p{i}": leaves with a leading group axis}."""
    return {f"p{i}": _stack([_block_init(gen, cfg, device)
                             for _ in range(num_groups)])
            for i in range(len(cfg.layer_kinds()))}


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Tree:
    """Random params of `cfg` from `gen`, on `device` (default: the
    generator's). On the "meta" device nothing is allocated and `gen`
    may be None. The draws differ from the reference's (another RNG);
    the layout and the distributions are its."""
    check_supported(cfg)
    device = torch.device(device if device is not None else gen.device)
    params = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   cfg.tdtype, device),
        "blocks": _stack_init(gen, cfg, device,
                              num_groups=cfg.num_pattern_groups),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, cfg.tdtype,
                                       device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                              cfg.vocab_size, cfg.tdtype,
                                              device)
    return params


# ============================================================ positions


def _rope_for(cfg, b: int, t: int, offset: int = 0, device=None):
    """cos/sin (B, T, hd/2) of positions offset .. offset + T - 1."""
    pos = (torch.arange(t, device=device)[None] + offset).repeat(b, 1)
    return layers.rope_cos_sin(pos, cfg.hd, cfg.rope_theta)


# =============================================================== blocks


def _block(bp, cfg, x, ctx, cache, mode):
    """One block. Returns (x, new_cache)."""
    h = layers.norm_apply(bp["norm1"], x)
    if mode == "decode":
        y, new_cache = attention.attn_decode(
            bp["mixer"], cfg, h, cache, ctx["pos"], ctx["cos"], ctx["sin"],
            window=ctx["window"])
    else:
        y, new_cache = attention.attn_forward(
            bp["mixer"], cfg, h, ctx["cos"], ctx["sin"], causal=True,
            window=ctx["window"], return_cache=(mode == "prefill"),
            max_len=ctx["max_len"] if mode == "prefill" else 0)
    x = x + y
    hf = layers.norm_apply(bp["norm2"], x)
    return x + layers.mlp_apply(bp["ffn"], hf, cfg.mlp), new_cache


def _run_stack(blocks, cfg, x, ctx, mode, cache=None):
    """Run the stacked groups in order. Returns (x, aux, cache|None):
    prefill returns a new cache stacked over groups; decode writes into
    `cache` in place and returns it."""
    positions = range(len(cfg.layer_kinds()))
    caches = {f"p{i}": [] for i in positions}
    for gi in range(cfg.num_pattern_groups):
        for i in positions:
            sub = _index(blocks[f"p{i}"], gi)
            c_in = _index(cache[f"p{i}"], gi) if mode == "decode" else None
            x, nc = _block(sub, cfg, x, ctx, c_in, mode)
            if mode == "prefill":
                caches[f"p{i}"].append(nc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "prefill":
        cache = {k: _stack(v) for k, v in caches.items()}
    return x, aux, cache if mode in ("prefill", "decode") else None


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ================================================================ public


def embed_inputs(params, cfg, batch):
    """Token embedding. Returns (x, text_offset)."""
    return params["embed"][batch["tokens"]], 0


def forward(params, cfg: ModelConfig, batch, *, mode: str = "train",
            max_len: int = 0):
    """Full-sequence forward. mode: "train" | "prefill"."""
    check_supported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(mode)
    x, text_offset = embed_inputs(params, cfg, batch)
    b, t = x.shape[0], x.shape[1]
    cos, sin = _rope_for(cfg, b, t, device=x.device)
    ctx = {"cos": cos, "sin": sin, "pos": None,
           "window": cfg.sliding_window, "max_len": max(max_len, t)}
    x, aux, cache = _run_stack(params["blocks"], cfg, x, ctx, mode)
    x = layers.norm_apply(params["final_norm"], x)
    logits = unembed(params, cfg, x)
    if mode == "prefill":
        return logits, aux, cache
    return logits, aux, text_offset


def unembed(params, cfg, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """One-token decode. token (B,1) int; pos the absolute position.

    Returns (logits (B,1,V), cache): the token's keys and values are
    written into `cache` in place."""
    check_supported(cfg)
    pos = int(pos)
    x = params["embed"][token]
    cos, sin = _rope_for(cfg, x.shape[0], 1, offset=pos, device=x.device)
    ctx = {"cos": cos, "sin": sin, "pos": pos,
           "window": cfg.sliding_window, "max_len": 0}
    x, _, cache = _run_stack(params["blocks"], cfg, x, ctx, "decode", cache)
    x = layers.norm_apply(params["final_norm"], x)
    return unembed(params, cfg, x), cache


def init_cache(cfg: ModelConfig, b: int, max_len: int,
               device=None) -> Tree:
    """Zero-initialised decode cache (leaves stacked over groups)."""
    check_supported(cfg)
    g = cfg.num_pattern_groups
    s = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
    shape = (g, b, s, cfg.num_kv_heads, cfg.hd)
    return {f"p{i}": {"k": torch.zeros(shape, dtype=cfg.tdtype,
                                       device=device),
                      "v": torch.zeros(shape, dtype=cfg.tdtype,
                                       device=device)}
            for i in range(len(cfg.layer_kinds()))}


# ========================================================== param count


def count_params(cfg: ModelConfig) -> int:
    """Parameter count from the shapes of `init_params` on the meta
    device (nothing is allocated)."""
    shapes = init_params(None, cfg, device="meta")

    def total(tree) -> int:
        if isinstance(tree, dict):
            return sum(total(v) for v in tree.values())
        return math.prod(tree.shape)

    return total(shapes)
