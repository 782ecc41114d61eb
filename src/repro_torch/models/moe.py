"""Mixture-of-Experts FFN (DeepSeek-V2 style: shared + routed, top-k):
the counterpart of `repro/models/moe.py`.

Dispatch is sort-based with a fixed per-expert capacity (drop on
overflow), as in the reference: the (token, expert) assignments are
stably sorted by expert id, packed into an (E, C, d) buffer, run through
the stacked experts as one batched matmul, and combined back with their
gate weights. Assignments past an expert's capacity go to the overflow
row E*C and are dropped, the same ones as in the reference: token-major
order within an expert. The router runs in f32 even in a bf16 model;
the combine accumulates in `cfg.moe.combine_dtype`.

The scatters are out of place (`index_put`, `index_add`), so the
function is differentiable under autograd and `torch.func.grad`, and
none waits for the device (`torch.bincount` would: its output size is
read back to the host).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def moe_init(cfg) -> dict:
    m = cfg.moe
    d, dt = cfg.d_model, cfg.tdtype
    E, f = m.num_experts, m.d_ff_expert
    p = {
        "router": layers.dense_init(d, E, torch.float32),
        "w_gate": layers.stacked(E, layers.dense_init(d, f, dt)),
        "w_up": layers.stacked(E, layers.dense_init(d, f, dt)),
        "w_down": layers.stacked(E, layers.dense_init(f, d, dt)),
    }
    if m.num_shared:
        p["shared"] = layers.mlp_init(d, m.num_shared * f, "swiglu", dt)
    return p


def _capacity(num_tokens: int, m) -> int:
    c = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _route(p: dict, cfg, xf: torch.Tensor):
    """Routing of xf (N, d): the router's probs (N, E) f32, and per
    assignment in expert-sorted order its expert, token, gate and slot
    in the (E*C + 1)-row buffer, with `keep` False for those dropped by
    capacity (slot E*C)."""
    m = cfg.moe
    n = xf.shape[0]
    logits = xf.to(torch.float32) @ p["router"]  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True),
                                min=1e-9)

    C = _capacity(n, m)
    E = m.num_experts
    flat_e = eidx.reshape(-1)  # (N*k,), token-major
    flat_tok = torch.arange(n, device=xf.device).repeat_interleave(m.top_k)
    order = torch.argsort(flat_e, stable=True)
    se, stok, sgate = flat_e[order], flat_tok[order], gates.reshape(-1)[order]
    pos_in_e = (torch.arange(n * m.top_k, device=xf.device)
                - torch.searchsorted(se, se, side="left"))
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e,
                       torch.full_like(se, E * C))  # the overflow row
    return probs, flat_e, stok, sgate, slot, keep, C


def moe_apply(p: dict, cfg, x: torch.Tensor):
    """x (B, T, d) -> (y, aux_loss). Decode runs (B, 1, d) through the
    same function."""
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    probs, flat_e, stok, sgate, slot, keep, C = _route(p, cfg, xf)
    E = m.num_experts

    buf = torch.index_put(xf.new_zeros((E * C + 1, d)), (slot,), xf[stok])
    h = buf[:E * C].reshape(E, C, d)
    # grouped swiglu over the stacked experts
    g = F.silu(h @ p["w_gate"])
    u = h @ p["w_up"]
    ye = ((g * u) @ p["w_down"]).reshape(E * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], dim=0)

    contrib = ye[slot] * (sgate * keep).to(ye.dtype)[:, None]
    acc_dt = getattr(torch, m.combine_dtype)
    y = torch.zeros((n, d), dtype=acc_dt, device=x.device).index_add(
        0, stok, contrib.to(acc_dt))
    y = y.to(x.dtype)

    if "shared" in p:
        y = y + layers.mlp_apply(p["shared"], xf, "swiglu")

    # switch-style load-balance loss over all k assignments
    f_e = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (
        n * m.top_k)
    p_e = torch.mean(probs, dim=0)
    aux = m.aux_loss_weight * E * torch.sum(f_e * p_e)
    return y.reshape(b, t, d), aux
