"""The synchronous FedAdp / FedAvg / FedProx round, parallel mode, in torch.

The counterpart of `repro/core/fl.py` for the main path:
`make_round_fn(loss_fn, fl)` returns

    round_fn(state, batches, sel_idx, data_sizes) -> (state, metrics)

with the reference's signature, state contract and metrics keys. Inside
one round:

* the K clients run tau SGD steps each, batched over clients with
  `torch.func.vmap` over `torch.func.grad_and_value` of the functional
  loss (the tau steps are a Python loop);
* the uplink: the deltas are raveled once into a contiguous (K, N) f32
  buffer; on a quantized wire (transport="bf16" | "int8" | "int4") it is
  compressed once by `transport.quantize`, with the error-feedback
  residual replayed in and carried out when `error_feedback` is set;
* engine="flat": three passes stream over the wire buffer through the
  port's CUDA kernels, each dequantizing in registers:
  `weighted_agg(psi_avg, x)` (the FedAvg global delta g),
  `round_stats(x, g, mask)` (dots, squared norms, ||g||^2), and
  `weighted_agg(w, x)` with the FedAdp weights (fedavg/fedprox reuse g);
  on the int8 / int4 wire the `_q` / `_q4` variants of both;
* engine="tree": the same math as plain per-leaf torch on the
  dequantized wire (it never reads the wire buffer), the port's own
  cross-check of the flat engine;
* between the passes, O(K) scalar math: the Eq. 8 angles, the Eq. 9
  scatter and the Eq. 10-11 weights (`weighting`).

Angle convention: the paper's theta_i is between grad F and grad F_i with
grad F_i = -Delta_i/eta; the -1/eta factors cancel in the cosine, so the
deltas are correlated directly.

What the slice does not carry yet raises NotImplementedError naming the
ROADMAP item (Queue 1) that will bring it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import transport
from repro_torch.core import treemath, weighting
from repro_torch.core.weighting import AngleState
from repro_torch.kernels.round_stats import (
    round_stats,
    round_stats_q,
    round_stats_q4,
)
from repro_torch.kernels.weighted_agg import (
    weighted_agg,
    weighted_agg_q,
    weighted_agg_q4,
)
from repro_torch.transport import DOWNLINKS, GROUP_SIZE, TRANSPORTS

Tree = Any


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The reference's FLConfig: same fields, same defaults, same
    `validate()`. See `repro/core/fl.py` for each field's meaning.
    `interpret` is accepted and ignored: the port has no interpret mode
    (CPU tensors take the kernels' plain versions)."""

    num_clients: int  # population size (angle-state slots)
    clients_per_round: int  # K = |S_t|
    local_steps: int  # tau
    method: str = "fedadp"  # fedadp | fedavg | fedprox
    alpha: float = weighting.DEFAULT_ALPHA
    base_lr: float = 0.01
    lr_decay: float = 0.995  # per communication round (paper Sec. V)
    mode: str = "parallel"  # parallel | sequential
    stale_angles: bool = False
    engine: str = "tree"  # tree | flat | flat_sharded
    transport: str = "f32"  # f32 | bf16 | int8 | int4
    group_size: int = GROUP_SIZE
    downlink: str = "f32"  # f32 | bf16 | int8
    downlink_delta: bool = False
    downlink_ring: int = 8
    error_feedback: bool = False
    downlink_error_feedback: bool = False
    interpret: Optional[bool] = None
    angle_filter: str = "all"  # all | dense_only
    prox_mu: float = 0.0
    aggregation: str = "sync"  # sync | buffered
    buffer_m: int = 0
    staleness_beta: float = 0.3
    straggle_prob: float = 0.0
    straggle_max: int = 1
    dropout_prob: float = 0.0
    telemetry: Optional[str] = None  # None | "node"

    def validate(self) -> "FLConfig":
        """Check the config's cross-field invariants (every check of the
        reference). Raises ValueError naming the offending field; returns
        self so it chains."""
        if self.mode not in ("parallel", "sequential"):
            raise ValueError(
                f"unknown mode {self.mode!r} (expected 'parallel' or "
                "'sequential')")
        if self.method not in ("fedadp", "fedavg", "fedprox"):
            raise ValueError(
                f"unknown method {self.method!r} (expected 'fedadp', "
                "'fedavg', or 'fedprox')")
        if self.engine not in ("tree", "flat", "flat_sharded"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.angle_filter not in ("all", "dense_only"):
            raise ValueError(f"unknown angle_filter {self.angle_filter!r}")
        if self.telemetry not in (None, "node"):
            raise ValueError(
                f"unknown telemetry {self.telemetry!r} (expected None or "
                "'node')")
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r} (expected one of "
                f"{TRANSPORTS})")
        if self.downlink not in DOWNLINKS:
            raise ValueError(
                f"unknown downlink {self.downlink!r} (expected one of "
                f"{DOWNLINKS})")
        if self.transport == "int4":
            transport.validate_group_size(self.group_size)
        if self.error_feedback and self.transport == "f32":
            raise ValueError(
                "error_feedback carries the quantization residual; "
                "transport='f32' has none (set transport='bf16', 'int8', "
                "or 'int4')")
        if self.downlink_error_feedback and self.downlink == "f32":
            raise ValueError(
                "downlink_error_feedback carries the broadcast "
                "quantization residual; downlink='f32' has none (set "
                "downlink='bf16' or 'int8')")
        if self.downlink_delta and self.downlink == "f32":
            raise ValueError(
                "downlink_delta broadcasts the quantized model diff "
                "against the previous broadcast; downlink='f32' ships "
                "exact params and has nothing to gain from it (set "
                "downlink='bf16' or 'int8')")
        if self.downlink_delta and self.downlink_ring < 1:
            raise ValueError(
                f"downlink_ring={self.downlink_ring} must be >= 1")
        if not self.downlink_delta and self.downlink_ring != 8:
            raise ValueError(
                f"downlink_ring={self.downlink_ring} requires "
                "downlink_delta=True")
        if self.mode == "sequential":
            if self.engine != "tree":
                raise ValueError(
                    f"engine={self.engine!r} requires mode='parallel' "
                    "(sequential mode never materializes the stacked "
                    "(K, N) delta buffer)")
            if self.transport != "f32":
                raise ValueError(
                    "transport compresses the stacked parallel uplink "
                    "buffer; use mode='parallel' for quantized transport")
            if self.downlink != "f32":
                raise ValueError(
                    "quantized downlink is threaded through the parallel "
                    "round engines; use mode='parallel' for downlink != "
                    "'f32'")
        if self.aggregation not in ("sync", "buffered"):
            raise ValueError(
                f"unknown aggregation {self.aggregation!r} (expected "
                "'sync' or 'buffered')")
        if self.aggregation == "buffered":
            if self.mode != "parallel":
                raise ValueError(
                    "aggregation='buffered' requires mode='parallel'")
            if self.stale_angles:
                raise ValueError(
                    "stale_angles is the sequential one-pass variant; "
                    "unset it for aggregation='buffered'")
            if not 0 <= self.buffer_m <= self.clients_per_round:
                raise ValueError(
                    f"buffer_m={self.buffer_m} must be in "
                    f"[0, clients_per_round={self.clients_per_round}]")
            if self.staleness_beta < 0:
                raise ValueError(
                    f"staleness_beta={self.staleness_beta} must be >= 0")
            if not 0.0 <= self.straggle_prob <= 1.0:
                raise ValueError(
                    f"straggle_prob={self.straggle_prob} must be a "
                    "probability in [0, 1]")
            if not 0.0 <= self.dropout_prob <= 1.0:
                raise ValueError(
                    f"dropout_prob={self.dropout_prob} must be a "
                    "probability in [0, 1]")
            if self.straggle_prob > 0 and self.straggle_max < 1:
                raise ValueError(
                    f"straggle_max={self.straggle_max} must be >= 1 when "
                    "straggle_prob > 0")
        else:
            for field, val, default in (
                    ("buffer_m", self.buffer_m, 0),
                    ("straggle_prob", self.straggle_prob, 0.0),
                    ("dropout_prob", self.dropout_prob, 0.0)):
                if val != default:
                    raise ValueError(
                        f"{field}={val} requires aggregation='buffered'")
        return self


def check_in_slice(fl: FLConfig) -> None:
    """Raise NotImplementedError for a valid config that the port does
    not run yet, naming the ROADMAP (Queue 1) item that will bring it."""
    missing = [
        (fl.engine == "flat_sharded",
         "engine='flat_sharded' (ROADMAP Queue 1 item 13)"),
        (fl.mode == "sequential",
         "mode='sequential' (ROADMAP Queue 1 item 10)"),
        (fl.downlink != "f32" or fl.downlink_delta
         or fl.downlink_error_feedback,
         "a quantized or delta downlink (ROADMAP Queue 1 item 9)"),
        (fl.aggregation == "buffered",
         "aggregation='buffered' (ROADMAP Queue 1 item 11)"),
        (fl.telemetry is not None,
         "telemetry (ROADMAP Queue 1 item 12)"),
    ]
    for cond, what in missing:
        if cond:
            raise NotImplementedError(f"the torch port does not run {what} "
                                      "yet")


class RoundState(NamedTuple):
    """The server-side carry of a round: the reference's RoundState for
    the sync path with the uplink wire (the downlink and buffer fields
    arrive with their slices).

    `rng` is the driver's `torch.Generator`; it advances in place as the
    driver draws selections and batches (round_fn never touches it).
    `round` is a host int (it drives the lr schedule)."""

    params: Tree  # the server's master model
    angle: AngleState  # Eq. 9 smoothed angles + participation counts
    prev_delta: Tree  # last FedAvg-weighted global delta, f32 leaves
    ef: Optional[torch.Tensor] = None  # (num_clients, N) uplink EF residual
    rng: Optional[torch.Generator] = None
    round: int = 0


def param_count(params: Tree) -> int:
    """Total scalar parameter count N (the flat-buffer width)."""
    return sum(p.numel() for p in treemath.tree_leaves(params))


def init_prev_delta(params: Tree) -> Tree:
    return treemath.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def init_round_state(fl: FLConfig, params: Tree,
                     seed: "int | torch.Generator" = 0) -> RoundState:
    """Fresh RoundState for `params` under `fl`, on the params' device.
    `seed` is an int (a new generator on that device is seeded with it)
    or an existing `torch.Generator`. The uplink EF residual is allocated
    only when `fl.error_feedback` is set."""
    fl.validate()
    check_in_slice(fl)
    device = treemath.tree_leaves(params)[0].device
    if isinstance(seed, torch.Generator):
        rng = seed
    else:
        rng = torch.Generator(device=device).manual_seed(int(seed))
    ef = (transport.init_error_feedback(fl.num_clients, param_count(params),
                                        device)
          if fl.error_feedback else None)
    return RoundState(params=params,
                      angle=AngleState.init(fl.num_clients, device),
                      prev_delta=init_prev_delta(params), ef=ef, rng=rng,
                      round=0)


def local_update(loss_fn: Callable, params: Tree, batches: Tree, lr,
                 prox_mu: float = 0.0):
    """tau steps of SGD on one client; batches' leaves are (tau, B, ...).

    prox_mu > 0 adds FedProx's proximal term mu/2 ||w - w(t-1)||^2
    against the round's starting params. Returns (delta, mean_loss)."""
    if prox_mu > 0.0:
        base = loss_fn

        def loss_fn(p, b):  # noqa: F811 (intentional wrap)
            prox = treemath.tree_sqnorm(treemath.tree_sub(p, params))
            return base(p, b) + 0.5 * prox_mu * prox

    grad_fn = torch.func.grad_and_value(loss_fn)
    tau = treemath.tree_leaves(batches)[0].shape[0]
    p, losses = params, []
    for t in range(tau):
        g, loss = grad_fn(p, treemath.tree_map(lambda a: a[t], batches))
        p = treemath.tree_axpy(-lr, g, p)
        losses.append(loss)
    return treemath.tree_sub(p, params), torch.mean(torch.stack(losses))


def angle_keep_list(params: Tree, pred: Callable) -> list:
    """One bool per leaf (flatten order): does `pred(path_keys, leaf)`
    keep it?"""
    return [bool(pred(path, leaf)) for path, leaf in
            zip(treemath.tree_paths(params), treemath.tree_leaves(params))]


def build_angle_mask(params: Tree, pred: Callable) -> Callable:
    """Leaf filter decided ONCE on the param tree: the returned function
    maps any tree with the same flatten order (params, deltas, stacked
    deltas) to the list of its kept leaves."""
    keep = angle_keep_list(params, pred)

    def mask(tree):
        leaves = treemath.tree_leaves(tree)
        assert len(leaves) == len(keep), "mask/tree flatten-order mismatch"
        return [l for l, k in zip(leaves, keep) if k]

    return mask


def moe_dense_only_pred(keys, leaf) -> bool:
    """Keep everything except stacked routed-expert weights: leaves named
    w_gate/w_up/w_down under 'ffn' with an expert axis (rank >= 4)."""
    return not ("ffn" in keys and keys[-1] in ("w_gate", "w_up", "w_down")
                and leaf.ndim >= 4)


def _scatter_angles(state: AngleState, sel_idx: torch.Tensor,
                    theta: torch.Tensor) -> AngleState:
    n = state.smoothed.shape[0]
    sel = sel_idx.to(torch.int64)
    mask = torch.zeros(n, dtype=torch.bool, device=theta.device)
    mask[sel] = True
    theta_full = torch.zeros(n, dtype=torch.float32, device=theta.device)
    theta_full[sel] = theta
    return weighting.update_smoothed_angle(state, theta_full, mask)


def _lr_at(fl: FLConfig, round_idx: int) -> float:
    """base_lr * lr_decay ** round, in f32 as the reference computes it."""
    r = np.float32(round_idx)
    return float(np.float32(fl.base_lr) * np.float32(fl.lr_decay) ** r)


def _agg_wire(w: torch.Tensor,
              wire: transport.QuantizedDelta) -> torch.Tensor:
    """The f32 aggregate over the wire buffer, by its format."""
    if wire.scales is None:  # f32 or bf16: the f32 kernel loads both
        return weighted_agg(w, wire.values, out_dtype=torch.float32)
    if wire.transport == "int4":
        return weighted_agg_q4(w, wire.values, wire.scales, n=wire.n,
                               group_size=wire.group_size)
    return weighted_agg_q(w, wire.values, wire.scales)


def _stats_wire(wire: transport.QuantizedDelta, g: torch.Tensor,
                mask: Optional[torch.Tensor]):
    """(dots, sqs, sqg) over the wire buffer, by its format."""
    if wire.scales is None:
        return round_stats(wire.values, g, mask)
    if wire.transport == "int4":
        return round_stats_q4(wire.values, wire.scales, g, mask,
                              group_size=wire.group_size)
    return round_stats_q(wire.values, wire.scales, g, mask)


def make_round_fn(loss_fn: Callable, fl: FLConfig,
                  angle_pred: Optional[Callable] = None) -> Callable:
    """Build the synchronous parallel round (engine "flat" or "tree").

    round_fn(state, batches, sel_idx, data_sizes) -> (state, metrics):
    batches' leaves are (K, tau, B, ...), sel_idx (K,) integer population
    slots, data_sizes (K,) f32, all on the state's device. When
    `angle_pred` is None, `fl.angle_filter` picks the built-in predicate
    ("dense_only" -> `moe_dense_only_pred`). With `fl.error_feedback` the
    round reads and rewrites `state.ef` (a new tensor: the input state is
    left as it was).
    """
    fl.validate()
    check_in_slice(fl)
    if angle_pred is None and fl.angle_filter == "dense_only":
        angle_pred = moe_dense_only_pred
    masks: dict = {}  # (N,) segment mask per device, built once

    def clients(params, batches, lr):
        return torch.func.vmap(
            lambda b: local_update(loss_fn, params, b, lr, fl.prox_mu),
            randomness="error")(batches)

    def round_fn(state: RoundState, batches, sel_idx, data_sizes):
        if fl.error_feedback and state.ef is None:
            raise ValueError(
                "fl.error_feedback=True: state.ef is missing; build the "
                "state with init_round_state (or pass an (num_clients, N) "
                "f32 residual from transport.init_error_feedback)")
        params, angle_state = state.params, state.angle
        lr = _lr_at(fl, state.round)
        deltas, losses = clients(params, batches, lr)
        psi_avg = weighting.fedavg_weights(data_sizes)
        new_ef = state.ef

        # ---- the uplink: ravel once, compress once to the wire ----
        if fl.engine == "flat" or fl.transport != "f32":
            flat, unravel = treemath.tree_ravel_stacked(deltas)
            sel = sel_idx.to(torch.int64)
            if fl.error_feedback:
                # EF-SGD: replay the carried residual into this round's
                # signal, then carry what quantization drops this round
                flat = flat + state.ef[sel]
            wire = transport.quantize(flat, fl.transport,
                                      group_size=fl.group_size)
            if fl.error_feedback or fl.engine == "tree":
                recon = transport.dequantize(wire)
            if fl.error_feedback:
                new_ef = state.ef.index_copy(0, sel, flat - recon)
            if fl.engine == "tree":
                # the tree engine never reads the wire buffer: it runs the
                # per-leaf reductions on the dequantized f32 leaves
                deltas = treemath.tree_unravel_stacked(deltas, recon,
                                                       torch.float32)

        if fl.engine == "flat":
            maskv = None
            if angle_pred:
                dev = data_sizes.device
                if dev not in masks:
                    masks[dev] = treemath.segment_mask(
                        params, angle_keep_list(params, angle_pred))
                maskv = masks[dev]
            g_flat = _agg_wire(psi_avg, wire)
            dots, sqs, sqg = _stats_wire(wire, g_flat, maskv)
            g_avg = unravel(g_flat, torch.float32)
        else:
            angle_mask = (build_angle_mask(params, angle_pred)
                          if angle_pred else None)
            g_avg = treemath.tree_weighted_sum(deltas, psi_avg,
                                               torch.float32)
            d_view = angle_mask(deltas) if angle_mask else deltas
            g_view = angle_mask(g_avg) if angle_mask else g_avg
            dots = treemath.tree_vdot_batched(d_view, g_view)
            sqs = treemath.tree_sqnorm_batched(d_view)
            sqg = treemath.tree_sqnorm(g_view)
        theta = weighting.instantaneous_angle(dots, sqs, sqg)

        # Eq. 9 scatter, one copy for both engines
        new_angle = _scatter_angles(angle_state, sel_idx, theta)
        theta_sm = new_angle.smoothed[sel_idx.to(torch.int64)]
        if fl.method == "fedadp":
            w = weighting.fedadp_weights(theta_sm, data_sizes, fl.alpha)
        else:  # fedavg / fedprox aggregate by data size
            w = psi_avg
        if fl.engine == "flat":
            # fedavg/fedprox aggregate with w == psi_avg: reuse g_flat
            delta_flat = _agg_wire(w, wire) if fl.method == "fedadp" \
                else g_flat
            delta = unravel(delta_flat)
        else:
            delta = treemath.tree_map(
                lambda d, p: d.to(p.dtype),
                treemath.tree_weighted_sum(deltas, w, torch.float32), params)
        new_params = treemath.tree_add(params, delta)

        # Fig. 7 divergence: (1/K) sum_i ||dF - dF_i|| with dF ~ -delta/lr
        div = torch.mean(torch.sqrt(
            torch.clamp(sqs - 2 * dots + sqg, min=0.0))) / lr
        cos = torch.cos(theta)
        metrics = {
            "loss": torch.mean(losses), "theta": theta,
            "theta_smoothed": theta_sm, "weights": w, "divergence": div,
            "lr": torch.tensor(lr, dtype=torch.float32,
                               device=data_sizes.device),
            "cos": cos,
            "expected_contribution": weighting.expected_contribution(w, cos),
        }
        return state._replace(params=new_params, angle=new_angle,
                              prev_delta=g_avg, ef=new_ef,
                              round=state.round + 1), metrics

    return round_fn
