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

Inside a `tp.scope` the routing runs replicated on every model rank (the
router in f32, the capacity C of the whole batch), bit for bit the
same, and the experts run parallel, each leaf's split read from its
width. Where the rules split the stacked experts on E (E % M == 0: expert
parallelism), each rank packs and runs only the slots of its E/M
experts; the shared experts are Megatron-split like the dense FFN; the
routed and shared partial outputs are summed in one
`tp.reduce_from_model`. Where they put "model" on each expert's last dim
instead (`f` of `w_gate` / `w_up`, `d` of `w_down`), every rank runs
every expert on its block of `f`, and the hidden and the output are
gathered over "model". The dispatched tokens and the gates feed the
rank's own experts, so both pass `tp.copy_to_model`; the aux loss stays
on the replicated path and is added once. A serving step whose rows are
split over "data" routes the rows of every data index together
(`tp.gather_rows`), as the reference routes its whole batch.
`record_routing()` lists each call's routing, for checks.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models import layers, tp

_ROUTING: list = []  # the lists of the open `record_routing` blocks


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


@contextlib.contextmanager
def record_routing():
    """A list of each MoE call's routing inside the block: dicts of the
    assignments' experts (token-major), the expert-sorted slots, keep
    flags and gates (detached)."""
    log: list = []
    _ROUTING.append(log)
    try:
        yield log
    finally:
        _ROUTING.remove(log)


def _f_split(p: dict) -> bool:
    """Whether `w_gate` / `w_up` hold a block of each expert's `f` (the
    rules' fallback where E does not divide over "model")."""
    return p["w_gate"].shape[-1] != p["w_down"].shape[-2]


def _experts(p: dict, h: torch.Tensor, d: int) -> torch.Tensor:
    """The grouped swiglu of the stacked experts over h (E_loc, C, d):
    (E_loc * C, d). Where the blocks hold a slice of every expert's `f`
    (and of `d` in `w_down`), the hidden and the output are gathered."""
    g = F.silu(h @ p["w_gate"])
    hid = g * (h @ p["w_up"])
    if _f_split(p):  # the whole hidden
        hid = tp.gather_from_model(hid, -1)
    if p["w_down"].shape[-1] != d:  # a block of d: the whole output
        ye = tp.gather_from_model(tp.copy_to_model(hid) @ p["w_down"], -1)
    else:
        ye = hid @ p["w_down"]
    return ye.reshape(-1, d)


def moe_apply(p: dict, cfg, x: torch.Tensor):
    """x (B, T, d) -> (y, aux_loss). Decode runs (B, 1, d) through the
    same function."""
    m = cfg.moe
    b, t, d = x.shape
    xf = tp.gather_rows(x.reshape(b * t, d))  # every data index's rows
    n = xf.shape[0]
    probs, flat_e, stok, sgate, slot, keep, C = _route(p, cfg, xf)
    for log in _ROUTING:
        log.append({"experts": flat_e.detach(), "slots": slot.detach(),
                    "keep": keep.detach(), "gates": sgate.detach()})
    E = m.num_experts
    e_loc = p["w_gate"].shape[-3]
    shared_f = m.num_shared * m.d_ff_expert
    acc_dt = getattr(torch, m.combine_dtype)

    # expert parallelism: this rank's E/M experts, their slots from lo;
    # otherwise every expert (whole, or a block of each expert's f), and
    # the dropped assignments already point at the padding row E*C
    ep = tp.split(e_loc, E) > 1
    lo = tp.block_start(e_loc) * C if ep else 0
    mine = keep & (slot >= lo) & (slot < lo + e_loc * C)
    lslot = torch.where(mine, slot - lo, torch.full_like(slot, e_loc * C))
    xs = tp.copy_to_model(xf) if ep or _f_split(p) else xf
    gates = tp.copy_to_model(sgate) if ep else sgate
    buf = torch.index_put(xs.new_zeros((e_loc * C + 1, d)), (lslot,),
                          xs[stok])
    ye = _experts(p, buf[:e_loc * C].reshape(e_loc, C, d), d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], dim=0)
    contrib = ye[lslot] * (gates * mine).to(ye.dtype)[:, None]
    y = torch.zeros((n, d), dtype=acc_dt, device=x.device).index_add(
        0, stok, contrib.to(acc_dt)).to(x.dtype)
    # the routed and a Megatron-split shared partial: one reduce
    fused = ep and "shared" in p and layers.mlp_sharded(p["shared"],
                                                        shared_f)
    if fused:
        y = y + layers.mlp_apply(p["shared"], xf, "swiglu", shared_f,
                                 reduce=False)
    if ep:
        y = tp.reduce_from_model(y)
    if "shared" in p and not fused:
        y = y + layers.mlp_apply(p["shared"], xf, "swiglu", shared_f)

    # switch-style load-balance loss over all k assignments
    f_e = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (
        n * m.top_k)
    p_e = torch.mean(probs, dim=0)
    aux = m.aux_loss_weight * E * torch.sum(f_e * p_e)
    return tp.own_rows(y, b * t).reshape(b, t, d), aux
