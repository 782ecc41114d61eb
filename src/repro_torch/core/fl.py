"""The FedAdp / FedAvg / FedProx round in torch: parallel, sequential
and buffered-async.

The counterpart of `repro/core/fl.py`. `make_round_fn(loss_fn, fl)`
returns

    round_fn(state, batches, sel_idx, data_sizes) -> (state, metrics)

with the reference's parameters, state contract and metrics keys. The
parallel round (mode="parallel", aggregation="sync"):

* the downlink: with `downlink` "bf16" or "int8" the params are raveled
  and compressed once (`transport.downlink`; their diff against the
  broadcast chain head under `downlink_delta`, the carried residual
  replayed in under `downlink_error_feedback`); every client trains from
  the same reconstruction, and the aggregate lands on the server's
  uncompressed master copy;
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
  scatter and the Eq. 10-11 weights (`weighting`);
* engine="flat_sharded" (with `mesh=`, a `launch.mesh.ClientMesh`): the
  flat engine split over the ranks of a client mesh. Every rank runs the
  same round on the same arguments, trains only its rows of the client
  axis zero-padded to a multiple of that axis's size, and streams them
  through the same kernels; `core.fl_shard_map.make_round_ops` sums the
  partial aggregates and statistics with `all_reduce`, and the rows the
  state keeps (the EF residual, the losses) are broadcast from their
  owners, so every rank ends the round with the same state, bit for bit;
* on a 2D ("data", "model") mesh (a model axis of size M > 1) the uplink
  is the reference's 2D wire: flat_sharded runs
  `fl_shard_map.make_round_ops_2d` on each rank's (K_loc, N_loc) tile of
  the blocked layout (quantization chunks shard-local), the tree engine
  reads the same wire through `make_blocked_roundtrip`, and error
  feedback on a quantized uplink is refused. Two points are the port's
  own. First, `make_round_fn` keeps the mesh for the tree engine only
  on a 2D mesh (the reference passes it to both engines of the 2D
  wire): the tree engine then trains every client on every rank and
  quantizes every model block locally, which gives the reference's
  blocked roundtrip bit for bit, since each row's int8 / int4 chunks
  depend only on its own model block. Second, where the reference's
  partitioner decides from the params' shardings, the port takes one
  explicit signal: `make_round_fn(..., param_specs=)`, the spec tree
  of the global params. With it the state's params and `prev_delta` are
  this rank's blocks (`models.sharding.shard_params`), each client
  trains tensor-parallel over "model" (`models/tp.py`, entered around
  client training), the delta blocks go straight to the region, and the
  region's blocks land on the param blocks: no param-sized leaf is
  gathered on the round path. The tree engine does the same with every
  client on every model group, summing the model-sharded leaves' partial
  dots and squared norms over "model". Without it the ranks of one
  model group train whole models and get the same deltas, each cuts and
  ravels only its own block, and after the region the round all-gathers
  each model-sharded leaf of g and of the delta over "model", so every
  rank's params stay whole: the oracle of the sharded state.

mode="sequential" trains one client at a time, twice (or once against
the previous round's delta with `stale_angles`), with each client's
statistics through `round_stats` on a (1, N) view. Given `param_specs`
of `param_pspecs(..., fsdp=True)` and a mesh, it is the reference's
FSDP round: the params and every param-sized tree of the round stay in
this rank's blocks on both axes, each client trains on this data
index's rows with each group gathered over "data" where it runs
(`models/tp.py`), and the statistics run through `round_stats` on the
rank's (1, n_local) block under an ownership mask, summed over the mesh
in one (3,) all-reduce. aggregation="buffered"
makes a call one tick of the buffered-async server (`core.buffer`): its
flat engine streams the buffer's f32 rows through the f32 kernels (the
sharded engine each rank's rows of it, after every rank has admitted the
same f32 reports).

`FLConfig(telemetry="node")` adds the reference's ``tel/*`` metrics to
every round (`_telemetry_metrics`), computed on the device; with
telemetry off the round never reaches that code. `state_to_tree` /
`state_from_tree` are the RoundState codec of `checkpoint.io`, with
elastic K.

Angle convention: the paper's theta_i is between grad F and grad F_i with
grad F_i = -Delta_i/eta; the -1/eta factors cancel in the cosine, so the
deltas are correlated directly.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

import repro_torch
from repro_torch import transport
from repro_torch.checkpoint.io import GeneratorState
from repro_torch.core import buffer as buffer_mod
from repro_torch.core import fl_shard_map, treemath, weighting
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
from repro_torch.launch.mesh import check_mesh
from repro_torch.transport import DOWNLINKS, GROUP_SIZE, TRANSPORTS, downlink

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
                    "buffer; sequential mode streams one client at a "
                    "time (use mode='parallel' for quantized transport)")
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


class RoundState(NamedTuple):
    """The server-side carry of a round, the reference's RoundState field
    for field. Optional fields are None when their FLConfig flag is off.

    `rng` is the driver's `torch.Generator`; it advances in place as the
    driver draws selections and batches (and a stochastic buffered tick
    its arrivals). `round` is a host int (it drives the lr schedule)."""

    params: Tree  # the server's uncompressed master model
    angle: AngleState  # Eq. 9 smoothed angles + participation counts
    prev_delta: Tree  # last FedAvg-weighted global delta, f32 leaves
    ef: Optional[torch.Tensor] = None  # (num_clients, N) uplink EF residual
    dl_ef: Optional[torch.Tensor] = None  # (N,) downlink EF residual
    bcast: Optional[downlink.BroadcastState] = None  # downlink_delta state
    buf: Optional[buffer_mod.ReportBuffer] = None  # buffered reports
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
    or an existing `torch.Generator`. Allocates exactly the optional
    buffers the config asks for: the uplink EF rows, the downlink EF
    vector, the broadcast state and the report buffer."""
    fl.validate()
    device = treemath.tree_leaves(params)[0].device
    if isinstance(seed, torch.Generator):
        rng = seed
    elif device.type == "meta":
        # torch has no meta generator; a state on the meta device (the
        # dry run's) never draws, so it carries a seeded CPU one
        rng = torch.Generator().manual_seed(int(seed))
    else:
        rng = torch.Generator(device=device).manual_seed(int(seed))
    n = param_count(params)
    return RoundState(
        params=params,
        angle=AngleState.init(fl.num_clients, device),
        prev_delta=init_prev_delta(params),
        ef=(transport.init_error_feedback(fl.num_clients, n, device)
            if fl.error_feedback else None),
        dl_ef=(downlink.init_downlink_error_feedback(n, device)
               if fl.downlink_error_feedback else None),
        bcast=(downlink.init_broadcast_state(n, fl.num_clients,
                                             fl.downlink_ring, device)
               if fl.downlink_delta else None),
        buf=(buffer_mod.init_report_buffer(fl.clients_per_round, n, device)
             if fl.aggregation == "buffered" else None),
        rng=rng, round=0)


def state_to_tree(state: RoundState) -> dict:
    """RoundState -> a nested dict `checkpoint.io.save` can round-trip,
    field for field as the reference's: NamedTuples become dicts,
    optional fields stay None (io writes `__none__` sentinels), `round`
    is a 0-d int32 tensor, and the generator is snapshotted as a
    `checkpoint.io.GeneratorState` (its device type and `get_state()`
    bytes). `state_from_tree` is the inverse."""
    return {
        "params": state.params,
        "angle": {"smoothed": state.angle.smoothed,
                  "count": state.angle.count},
        "prev_delta": state.prev_delta,
        "ef": state.ef,
        "dl_ef": state.dl_ef,
        "bcast": None if state.bcast is None else state.bcast._asdict(),
        "buf": None if state.buf is None else state.buf._asdict(),
        "rng": None if state.rng is None else GeneratorState.of(state.rng),
        "round": torch.tensor(state.round, dtype=torch.int32),
    }


def _resize_rows(a: torch.Tensor, k_new: int, fill=0) -> torch.Tensor:
    """Truncate / pad axis 0 to `k_new` rows (elastic-K restore). New
    rows are `fill`: zero for angle/EF state (fresh clients start like
    round-0 clients), `downlink.NEVER_PULLED` for the broadcast version
    vector (fresh clients need a full-model resync)."""
    k_old = a.shape[0]
    if k_new <= k_old:
        return a[:k_new]
    pad = torch.full((k_new - k_old,) + tuple(a.shape[1:]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def _named_leaves(state: RoundState) -> dict:
    """{path: leaf} over every field of `state` but rng and round, None
    leaves included, in flatten order."""
    tree = state_to_tree(state._replace(rng=None))
    del tree["rng"], tree["round"]
    return {"/".join(map(str, p)): leaf for p, leaf in
            zip(treemath.tree_paths(tree), treemath.tree_leaves(tree))}


def state_from_tree(cfg: FLConfig, tree: dict, device=None) -> RoundState:
    """Rebuild a RoundState from `state_to_tree`'s dict under `cfg`, on
    `device` (CUDA when None: raises without a GPU), with every check of
    the reference's `state_from_tree`.

    Each optional field (ef / dl_ef / bcast / buf) must be present
    exactly when the matching flag is on, and every leaf is validated
    (shape AND dtype) against `init_round_state`'s allocation for this
    config, built on the meta device (it costs nothing at full width),
    so a checkpoint from a different model or an incompatible config
    fails loudly instead of mis-resuming.

    Elastic K: when `cfg.num_clients` differs from the checkpoint's, the
    angle rows and uplink-EF rows are truncated or padded with 0 and
    `bcast.ver` is padded with `NEVER_PULLED`, so new clients start like
    round-0 clients; the report buffer `buf` restores verbatim (a K
    mismatch fails the shape check). A checkpoint of the legacy shared
    'prev_broadcast' vector is rejected. The generator continues its
    stream on `device`; a generator state of another device type raises
    ValueError naming both."""
    missing = [k for k in ("params", "angle", "prev_delta", "rng", "round")
               if tree.get(k) is None]
    if missing:
        raise ValueError(
            f"checkpoint tree lacks required RoundState fields {missing} "
            "— was it written by fl.state_to_tree?")
    if tree.get("prev_broadcast") is not None:
        raise ValueError(
            "checkpoint carries the legacy shared 'prev_broadcast' vector "
            "— it was written by a pre-ring repo revision whose "
            "downlink-delta state had no per-client decode bases; the "
            "per-client BroadcastState (ring/head/ver) cannot be "
            "reconstructed from it. Re-run the training (or restore under "
            "the revision that wrote it)")
    for name, flag, want in (
            ("ef", "error_feedback", cfg.error_feedback),
            ("dl_ef", "downlink_error_feedback", cfg.downlink_error_feedback),
            ("bcast", "downlink_delta", cfg.downlink_delta)):
        have = tree.get(name) is not None
        if want and not have:
            raise ValueError(
                f"cfg.{flag}=True but the checkpoint has no {name!r} — it "
                "was written under a config with the feature off; restore "
                "with a matching config (or re-init that buffer yourself)")
        if have and not want:
            raise ValueError(
                f"checkpoint carries {name!r} but cfg.{flag}=False — "
                "dropping a live residual would silently change the run; "
                "restore with a matching config")
    buffered = cfg.aggregation == "buffered"
    have_buf = tree.get("buf") is not None
    if buffered and not have_buf:
        raise ValueError(
            "cfg.aggregation='buffered' but the checkpoint has no 'buf' — "
            "it was written by a sync-aggregation run; restore with a "
            "matching config (or re-init the report buffer yourself)")
    if have_buf and not buffered:
        raise ValueError(
            "checkpoint carries 'buf' but cfg.aggregation='sync' — "
            "dropping the in-flight reports would silently change the "
            "run; restore with a matching config")

    dev = (repro_torch.default_device() if device is None
           else torch.device(device))
    rng = tree["rng"]
    if not isinstance(rng, GeneratorState):
        raise ValueError(
            f"checkpoint 'rng' is a {type(rng).__name__}, not a "
            "torch.Generator state — was it written by fl.state_to_tree?")

    def to(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

    k = cfg.num_clients
    angle = AngleState(
        smoothed=_resize_rows(to(tree["angle"]["smoothed"], torch.float32),
                              k),
        count=_resize_rows(to(tree["angle"]["count"], torch.int32), k))
    ef = tree.get("ef")
    if ef is not None:
        ef = _resize_rows(to(ef), k)
    bcast = tree.get("bcast")
    if bcast is not None:
        bcast = downlink.BroadcastState(
            ring=to(bcast["ring"], torch.float32),
            head=to(bcast["head"], torch.float32),
            head_ver=to(bcast["head_ver"], torch.int32),
            ver=_resize_rows(to(bcast["ver"], torch.int32), k,
                             fill=downlink.NEVER_PULLED))
    buf = tree.get("buf")
    if buf is not None:
        # in-flight reports restore verbatim: resizing a report buffer
        # would orphan live slot ids
        buf = buffer_mod.ReportBuffer(
            data=to(buf["data"], torch.float32),
            slot=to(buf["slot"], torch.int32),
            sizes=to(buf["sizes"], torch.float32),
            age=to(buf["age"], torch.int32),
            wait=to(buf["wait"], torch.int32),
            free=to(buf["free"], torch.bool))
    rnd = torch.as_tensor(tree["round"])
    if rnd.shape != () or rnd.is_floating_point():
        raise ValueError(
            f"checkpoint leaf round has shape {tuple(rnd.shape)} dtype "
            f"{rnd.dtype}, but the config allocates () torch.int32")
    dl_ef = tree.get("dl_ef")
    state = RoundState(
        params=treemath.tree_map(to, tree["params"]), angle=angle,
        prev_delta=treemath.tree_map(to, tree["prev_delta"]), ef=ef,
        dl_ef=None if dl_ef is None else to(dl_ef), bcast=bcast, buf=buf,
        rng=rng.generator(dev), round=int(rnd))

    # validate against the config's own allocation: the same structure,
    # and shape/dtype equality on every leaf
    template = init_round_state(cfg, treemath.tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        state.params), seed=torch.Generator())
    got, want = _named_leaves(state), _named_leaves(template)
    if list(got) != list(want):
        raise ValueError(
            "restored RoundState structure does not match "
            f"init_round_state({cfg.num_clients} clients): got "
            f"{sorted(set(got) - set(want))}, want "
            f"{sorted(set(want) - set(got))}")
    for name, leaf in got.items():
        ref = want[name]
        if leaf is None:
            continue
        if leaf.shape != ref.shape or leaf.dtype != ref.dtype:
            raise ValueError(
                f"checkpoint leaf {name} has shape {tuple(leaf.shape)} "
                f"dtype {leaf.dtype}, but the config allocates "
                f"{tuple(ref.shape)} {ref.dtype} — wrong model or "
                "incompatible config")
    return state


def local_update(loss_fn: Callable, params: Tree, batches: Tree, lr,
                 prox_mu: float = 0.0,
                 grad_constraint: Optional[Callable] = None):
    """tau steps of SGD on one client; batches' leaves are (tau, B, ...).

    prox_mu > 0 adds FedProx's proximal term mu/2 ||w - w(t-1)||^2
    against the round's starting params. `grad_constraint`, when given,
    maps each step's gradient tree before the step (the reference uses it
    to re-shard gradients). Returns (delta, mean_loss)."""
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
        if grad_constraint is not None:
            g = grad_constraint(g)
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
    # index_fill, not `mask[sel] = True`: on CUDA that assignment copies
    # the Python scalar from the host and waits for the device
    mask = torch.zeros(n, dtype=torch.bool,
                       device=theta.device).index_fill(0, sel, True)
    theta_full = torch.zeros(n, dtype=torch.float32, device=theta.device)
    theta_full[sel] = theta
    return weighting.update_smoothed_angle(state, theta_full, mask)


def _scatter_angles_masked(state: AngleState, sel_idx: torch.Tensor,
                           theta: torch.Tensor,
                           valid: torch.Tensor) -> AngleState:
    """Eq. 9 over the rows where `valid` only: the other rows are routed
    to a spare last slot that is cut off, so a buffered flush smooths the
    angles of the reports it aggregated. With `valid` all True this is
    `_scatter_angles`."""
    n = state.smoothed.shape[0]
    idx = torch.where(valid, sel_idx.to(torch.int64), n)
    mask = torch.zeros(n + 1, dtype=torch.bool,
                       device=theta.device).index_fill(0, idx, True)
    theta_full = torch.zeros(n + 1, dtype=torch.float32, device=theta.device)
    theta_full[idx] = theta
    return weighting.update_smoothed_angle(state, theta_full[:n], mask[:n])


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


def _check_state(fl: FLConfig, state: RoundState) -> None:
    """Raise ValueError for a state that lacks a buffer the config
    needs."""
    for flag, field, how in (
            (fl.error_feedback, "ef", "transport.init_error_feedback"),
            (fl.downlink_error_feedback, "dl_ef",
             "transport.downlink.init_downlink_error_feedback"),
            (fl.downlink_delta, "bcast",
             "transport.downlink.init_broadcast_state"),
            (fl.aggregation == "buffered", "buf",
             "core.buffer.init_report_buffer")):
        if flag and getattr(state, field) is None:
            raise ValueError(
                f"the config needs state.{field}, which is missing; build "
                f"the state with init_round_state (or {how})")


def _broadcast(fl: FLConfig, state: RoundState):
    """The server->client downlink: (the params the clients train from,
    the new downlink EF residual, the new broadcast state). The params
    are compressed once as an (N,) vector (its diff against the chain
    head under delta encoding, with the residual replayed in under error
    feedback), and every client trains from the same reconstruction. The
    caller moves the pulling clients' `ver` rows."""
    if fl.downlink == "f32":
        return state.params, state.dl_ef, state.bcast
    pvec, punravel = treemath.tree_ravel(state.params)
    if fl.downlink_delta:
        pvec = pvec - state.bcast.head
    if fl.downlink_error_feedback:
        pvec = pvec + state.dl_ef
    recon = downlink.decompress(downlink.compress(pvec, fl.downlink))
    new_dl = pvec - recon if fl.downlink_error_feedback else state.dl_ef
    new_bcast = state.bcast
    if fl.downlink_delta:
        new_bcast = downlink.advance_broadcast(state.bcast, recon)
        recon = new_bcast.head
    return punravel(recon), new_dl, new_bcast


def _segment_masks(angle_pred: Optional[Callable]) -> Callable:
    """params -> the (N,) f32 segment mask of `angle_pred` on the params'
    device, built once a device (None without a predicate)."""
    masks: dict = {}

    def get(params) -> Optional[torch.Tensor]:
        if not angle_pred:
            return None
        dev = treemath.tree_leaves(params)[0].device
        if dev not in masks:
            masks[dev] = treemath.segment_mask(
                params, angle_keep_list(params, angle_pred))
        return masks[dev]

    return get


def _tree_stats(deltas: Tree, g_avg: Tree, params: Tree,
                angle_pred: Optional[Callable]):
    """(dots, sqs, sqg) of the tree engine: per-leaf reductions over the
    kept leaves."""
    angle_mask = build_angle_mask(params, angle_pred) if angle_pred else None
    d_view = angle_mask(deltas) if angle_mask else deltas
    g_view = angle_mask(g_avg) if angle_mask else g_avg
    return (treemath.tree_vdot_batched(d_view, g_view),
            treemath.tree_sqnorm_batched(d_view),
            treemath.tree_sqnorm(g_view))


def _metrics(losses, theta, theta_sm, w, div, lr, dev) -> dict:
    cos = torch.cos(theta)
    return {
        "loss": torch.mean(losses), "theta": theta,
        "theta_smoothed": theta_sm, "weights": w, "divergence": div,
        "lr": torch.full((), lr, dtype=torch.float32, device=dev),
        "cos": cos,
        "expected_contribution": weighting.expected_contribution(w, cos),
    }


def _weight_entropy(w: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the (re-normalized) aggregation weights: ln K
    under FedAvg with equal sizes, falling toward 0 as the Gompertz
    softmax concentrates on few nodes. Zero-sum rows (buffered non-flush
    ticks) report 0."""
    tot = torch.sum(w)
    p = w / torch.clamp(tot, min=1e-12)
    plogp = p * torch.log(torch.clamp(p, min=1e-38))
    h = -torch.sum(torch.where(p > 0, plogp, 0.0))
    return torch.where(tot > 0, h, 0.0)


def _telemetry_metrics(fl: FLConfig, params: Tree, node_ids: torch.Tensor,
                       w: torch.Tensor,
                       occupied: Optional[torch.Tensor] = None,
                       down_split=None, n: Optional[int] = None) -> dict:
    """The `FLConfig(telemetry="node")` metrics, one helper for every
    round kind so the tel/* keys cannot fork: `node_ids` attributes
    this round's theta/weights rows to population slots (sel_idx for a
    sync round, the report buffer's slot column for a buffered tick);
    `occupied` masks the rows that hold a live report (None = all). The
    wire bytes are the config's `transport.round_bytes`, except under
    downlink_delta, where the round passes `down_split` = (delta bytes,
    full bytes) of this round's actual pulls: they replace
    tel/bytes_down and ride as tel/bytes_down_delta / _full. Every value
    is made on the device, without a host sync. `n` is the model's
    parameter count where `params` are a rank's blocks."""
    dev = w.device
    rb = transport.round_bytes(fl.clients_per_round,
                               param_count(params) if n is None else n,
                               fl.transport, fl.downlink,
                               group_size=fl.group_size)
    ids = node_ids.to(torch.int64)
    if occupied is not None:
        ids = torch.where(occupied, ids, fl.num_clients)
    # a spare last slot takes the unoccupied rows and is cut off
    cohort = torch.zeros(fl.num_clients + 1, dtype=torch.bool, device=dev)
    cohort = cohort.index_fill(0, ids, True)[:fl.num_clients]
    out = {
        "tel/nodes": node_ids.to(torch.int32),
        "tel/cohort": cohort,
        "tel/weight_entropy": _weight_entropy(w),
        "tel/bytes_up": torch.full((), rb["up"], dtype=torch.float32,
                                   device=dev),
        "tel/bytes_down": torch.full((), rb["down"], dtype=torch.float32,
                                     device=dev),
    }
    if down_split is not None:
        down_delta, down_full = down_split
        out["tel/bytes_down"] = down_delta + down_full
        out["tel/bytes_down_delta"] = down_delta
        out["tel/bytes_down_full"] = down_full
    return out


def _down_byte_split(fl: FLConfig, n: int, ver_rows: torch.Tensor,
                     v: torch.Tensor, pulled: Optional[torch.Tensor] = None):
    """The actual downlink bytes of the clients pulling broadcast version
    `v` from last-pulled versions `ver_rows`: a delta-served client pays
    one payload per version it is behind, a resync client one full-model
    payload, each priced at `wire_bytes(1, n, downlink)`. `pulled` masks
    the rows that pulled this round (buffered admission; None = all).
    Returns (delta_bytes, full_bytes) as f32 device scalars."""
    unit = transport.wire_bytes(1, n, fl.downlink)
    resync = downlink.resync_mask(ver_rows, v, fl.downlink_ring)
    payloads_d = torch.where(resync, 0, v - ver_rows)
    payloads_f = resync.to(torch.int32)
    if pulled is not None:
        payloads_d = torch.where(pulled, payloads_d, 0)
        payloads_f = torch.where(pulled, payloads_f, 0)
    return (torch.sum(payloads_d).to(torch.float32) * unit,
            torch.sum(payloads_f).to(torch.float32) * unit)


def make_round_fn(loss_fn: Callable, fl: FLConfig,
                  delta_constraint: Optional[Callable] = None,
                  angle_pred: Optional[Callable] = None,
                  grad_constraint: Optional[Callable] = None,
                  mesh=None, arrival_fn: Optional[Callable] = None, *,
                  param_specs=None, rows_over_data: bool = True) -> Callable:
    """Build the round: round_fn(state, batches, sel_idx, data_sizes) ->
    (state, metrics), with the reference's parameters (by name and
    position), state contract and metrics keys.

    batches' leaves are (K, tau, B, ...), sel_idx (K,) integer population
    slots, data_sizes (K,) f32, all on the state's device.
    `delta_constraint` maps the stacked deltas right after the clients'
    local updates (parallel and buffered rounds), `grad_constraint` each
    local step's gradients (every mode), as in the reference, which uses
    both for sharding constraints. `mesh` (a `launch.mesh.ClientMesh`) is
    required by engine="flat_sharded", which splits the client axis over
    its ranks (K not divisible by the mesh size is zero-padded) and runs
    on the mesh's device. A mesh with a "model" axis of size > 1 is the
    2D (client x model) layout: the flat_sharded engine runs
    `fl_shard_map.make_round_ops_2d`, and the sync tree engine keeps
    the mesh too, for its blocked wire (`make_blocked_roundtrip`); the
    other engines ignore the mesh. When `angle_pred` is None,
    `fl.angle_filter` picks the built-in predicate ("dense_only" ->
    `moe_dense_only_pred`). `fl.mode` picks the parallel round (engine
    "flat" or "tree") or the sequential one; `fl.aggregation="buffered"`
    makes each call one buffered-async server tick, whose arrivals
    `arrival_fn(tick) -> (delay (K,), drop (K,))`
    (`core.server.fixed_arrival_schedule`) overrides; the sync round
    ignores it. The round returns new tensors for every field it changes:
    the input state is left as it was.

    `param_specs` (port-only, keyword): the UNSTACKED spec tree of the
    global params (`models.sharding.param_pspecs` on `mesh`). Given with
    a 2D mesh, the state's params and `prev_delta` are this rank's
    blocks of those specs, and each client trains tensor-parallel over
    the mesh's "model" axis (module docstring); the sync parallel round
    on the flat_sharded or tree engine, with the f32 downlink, runs it.
    In sequential mode the specs are `param_pspecs(..., fsdp=True)`'s,
    on a mesh of any shape: the FSDP round. Its `batches` then hold this
    data index's rows of each client's batch where the batch splits
    over "data" (`rows_over_data`, port-only, keyword), else all of
    them, on every rank (`rows_over_data=False`).
    """
    fl.validate()
    check_mesh(mesh)
    if fl.engine == "flat_sharded" and mesh is None:
        raise ValueError(
            "engine='flat_sharded' shards the (K, N) delta buffer over "
            "the mesh client axis; pass mesh= to make_round_fn")
    if param_specs is not None:
        _check_param_specs(fl, mesh, param_specs)
    if angle_pred is None and fl.angle_filter == "dense_only":
        angle_pred = moe_dense_only_pred
    if fl.mode == "sequential":
        return _make_sequential_round(
            loss_fn, fl, angle_pred, grad_constraint,
            None if param_specs is None else mesh, param_specs,
            rows_over_data)
    round_mesh = mesh if fl.engine == "flat_sharded" else None
    if fl.aggregation == "buffered":
        return _make_buffered_round(loss_fn, fl, delta_constraint,
                                    angle_pred, grad_constraint, round_mesh,
                                    arrival_fn)
    if fl.engine == "tree" and fl_shard_map.model_axis_size(mesh) > 1:
        round_mesh = mesh  # the 2D wire
    return _make_parallel_round(loss_fn, fl, delta_constraint, angle_pred,
                                grad_constraint, round_mesh, param_specs)


def _check_param_specs(fl: FLConfig, mesh, param_specs) -> None:
    """Raise for a round that cannot keep its params in blocks."""
    from repro_torch.models import tp

    if mesh is None or fl.engine not in ("flat_sharded", "tree"):
        raise ValueError(
            "param_specs places the params in blocks over a mesh's model "
            "axis: pass mesh= with engine='flat_sharded' or 'tree'")
    def specs_of(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in specs_of(v)]
        return [tree]

    on_data = mesh.client_size > 1 and any(
        tp.data_dim(spec) >= 0 for spec in specs_of(param_specs))
    for what, off in (("aggregation='buffered'",
                       fl.aggregation == "buffered"),
                      (f"downlink={fl.downlink!r}", fl.downlink != "f32"),
                      ("method='fedprox' in sequential mode",
                       fl.mode == "sequential" and fl.prox_mu > 0.0),
                      ("params on 'data' in parallel mode (the FSDP "
                       "specs are the sequential round's)",
                       fl.mode == "parallel" and on_data)):
        if off:
            raise NotImplementedError(
                f"{what} with param_specs: the round keeps its params in "
                "blocks only in the sync parallel and sequential rounds "
                "with the f32 downlink (ROADMAP Queue 1 item 13d)")


def _clients(loss_fn: Callable, fl: FLConfig,
             delta_constraint: Optional[Callable],
             grad_constraint: Optional[Callable]) -> Callable:
    """(params, batches, lr) -> (deltas, losses): the K clients' local
    updates batched with torch.func.vmap, then `delta_constraint` on the
    stacked deltas."""

    def clients(params, batches, lr):
        deltas, losses = torch.func.vmap(
            lambda b: local_update(loss_fn, params, b, lr, fl.prox_mu,
                                   grad_constraint),
            randomness="error")(batches)
        if delta_constraint is not None:
            deltas = delta_constraint(deltas)
        return deltas, losses

    return clients


def _sharded_clients(clients: Callable, mesh) -> Callable:
    """(params, batches, lr, k) -> (deltas, losses, real): this rank's
    clients of a K-client round, trained alone (the ranks of one model
    group train the same ones). `deltas` is the rank's stacked block of
    the client axis zero-padded to `fl_shard_map.padded_k(k, C)` (C the
    client axis's size): rows past K are zero (padding carries no data,
    so it gets zero weight and zero statistics). `real` slices the
    rank's rows below K (none on a rank past K), and `losses` holds
    their mean losses."""

    def run(params, batches, lr, k: int):
        kp = fl_shard_map.padded_k(k, fl_shard_map.client_axis_size(mesh))
        mine = fl_shard_map.flat_client_sharding(mesh).rows(kp)
        real = slice(min(mine.start, k), min(mine.stop, k))
        if real.stop > real.start:
            deltas, losses = clients(
                params, treemath.tree_map(lambda a: a[real], batches), lr)
        else:
            deltas = treemath.tree_map(
                lambda p: p.new_zeros((0,) + tuple(p.shape)), params)
            losses = torch.zeros(0, device=mesh.device)
        return (treemath.tree_map(lambda d: fl_shard_map.pad_rows(
            d, mine.stop - mine.start), deltas), losses, real)

    return run


def _derive_param_pspecs(params: Tree, mesh) -> Tree:
    """The UNSTACKED param specs of the 2D wire: the launch layer's
    name-based rules (`models.sharding.param_pspecs`) on the mesh."""
    from repro_torch.models import sharding

    return sharding.param_pspecs(params, mesh)


def _global_shapes(blocks: Tree, specs: Tree, msize: int) -> list:
    """Each leaf's global shape from this rank's block of it: the dim
    its spec puts on "model" times the axis's size."""
    out = []
    for x, spec in zip(treemath.tree_leaves(blocks),
                       treemath.tree_leaves_like(blocks, specs)):
        shape, d = list(x.shape), fl_shard_map._model_dim(spec)
        if d >= 0:
            shape[d] *= msize
        out.append(tuple(shape))
    return out


def _tp_clients(clients: Callable, mesh) -> Callable:
    """`clients` trained tensor-parallel over the mesh's model axis."""
    from repro_torch.models import tp

    def run(*args):
        with tp.scope(mesh):
            return clients(*args)

    return run


def _tree_stats_tp(deltas: Tree, g_avg: Tree, params: Tree,
                   angle_pred: Optional[Callable], mesh, specs: Tree):
    """`_tree_stats` on blocks: the model-sharded leaves' partial dots
    and squared norms summed over "model" (one (2K + 1,) all-reduce),
    the replicated leaves, whole on every rank, counted once."""
    angle_mask = build_angle_mask(params, angle_pred) if angle_pred else None
    d_view = angle_mask(deltas) if angle_mask else deltas
    g_view = angle_mask(g_avg) if angle_mask else g_avg
    parts = [[], []]  # (replicated, model-sharded) per-leaf statistics
    for d, g, spec in zip(treemath.tree_leaves(d_view),
                          treemath.tree_leaves(g_view),
                          treemath.tree_leaves_like(g_avg, specs)):
        dims = tuple(range(1, d.ndim))
        df, gf = d.to(torch.float32), g.to(torch.float32)
        parts[fl_shard_map._model_dim(spec) >= 0].append(torch.cat([
            torch.sum(df * gf[None], dim=dims),
            torch.sum(df * df, dim=dims),
            torch.sum(gf * gf).reshape(1)]))
    k = treemath.tree_leaves(deltas)[0].shape[0]
    dev = treemath.tree_leaves(g_avg)[0].device
    sums = [functools.reduce(torch.add, p) if p
            else torch.zeros(2 * k + 1, device=dev) for p in parts]
    total = sums[0] + mesh.all_reduce(sums[1], axes=("model",))
    return total[:k], total[k:2 * k], total[2 * k]


def _make_parallel_round(loss_fn: Callable, fl: FLConfig,
                         delta_constraint: Optional[Callable],
                         angle_pred: Optional[Callable],
                         grad_constraint: Optional[Callable],
                         mesh=None, param_specs=None) -> Callable:
    clients = _clients(loss_fn, fl, delta_constraint, grad_constraint)
    segment_mask = _segment_masks(angle_pred)
    # a "model" axis of size > 1 makes the wire the 2D blocked layout:
    # quantization chunks are shard-local, model-sharded leaves are
    # raveled a block a rank, and the flat_sharded aggregate comes out in
    # blocks; the tree engine reads the same wire through
    # fl_shard_map.make_blocked_roundtrip
    wire_2d = fl_shard_map.model_axis_size(mesh) > 1
    if wire_2d and fl.transport != "f32" and fl.error_feedback:
        raise ValueError(
            "error_feedback carries a global (num_clients, N) residual in "
            "tree-ravel order, but a (client x model) mesh quantizes the "
            "wire in shard-local blocked order; drop error_feedback or "
            "use a client-only mesh")
    # the params in this rank's blocks, each client tensor-parallel
    tp_specs = param_specs if wire_2d else None
    if tp_specs is not None:
        clients = _tp_clients(clients, mesh)
    sharded = mesh is not None and fl.engine == "flat_sharded"
    if sharded:
        sharded_clients = _sharded_clients(clients, mesh)
        if not wire_2d:
            round_ops = fl_shard_map.make_round_ops(
                mesh, alpha=fl.alpha, method=fl.method,
                transport=fl.transport, group_size=fl.group_size)
    regions: dict = {}  # the 2D round's region, built once a layout

    def specs_of(params):
        return (tp_specs if tp_specs is not None
                else _derive_param_pspecs(params, mesh))

    def global_template(params, kp: int):
        """A (kp, *global shape) meta tree of the params' leaves: shapes
        and dtypes only, each a stride-0 view of one element, so that it
        claims no storage (the dry run traces a rank on meta, where a
        storage counts as memory)."""
        leaves, treedef = treemath.tree_flatten(params)
        shapes = ([tuple(p.shape) for p in leaves] if tp_specs is None
                  else _global_shapes(params, tp_specs,
                                      fl_shard_map.model_axis_size(mesh)))
        return treemath.tree_unflatten(treedef, [
            torch.empty((), dtype=p.dtype, device="meta").expand((kp,) + s)
            for p, s in zip(leaves, shapes)])

    def region_2d(params, kp: int):
        """(make_round_ops_2d's op, the param specs) for a round of kp
        padded rows."""
        key = (kp, tuple(tuple(p.shape) for p in
                         treemath.tree_leaves(params)))
        if key not in regions:
            pspecs = specs_of(params)
            template = global_template(params, kp)
            keep = (angle_keep_list(params, angle_pred) if angle_pred
                    else None)
            regions[key] = (fl_shard_map.make_round_ops_2d(
                mesh, template, pspecs, alpha=fl.alpha, method=fl.method,
                transport=fl.transport, group_size=fl.group_size,
                keep=keep), pspecs)
        return regions[key]

    def sharded_uplink_2d(state, params, batches, sel, data_sizes,
                          psi_avg, lr):
        """The flat_sharded engine on a 2D mesh. With param_specs the
        rank's clients train tensor-parallel on its param blocks, their
        delta blocks go through the 2D region, and its block outputs are
        the round's. Without, the rank's clients train whole models, the
        rank's model blocks of their deltas go through the region, and
        the aggregates' model-sharded leaves are gathered after it, so
        every rank ends with whole params. Returns what `sharded_uplink`
        does (no EF: refused on a 2D wire)."""
        k = sel.shape[0]
        kp = fl_shard_map.padded_k(k, fl_shard_map.client_axis_size(mesh))
        deltas, losses, _ = sharded_clients(params, batches, lr, k)
        round_op, pspecs = region_2d(params, kp)
        pad = fl_shard_map.pad_rows
        if tp_specs is None:
            deltas = fl_shard_map.local_blocks(mesh, deltas, pspecs)
        # padding rows: zero deltas and zero data size, so zero weight
        g_avg, dots, sqs, sqg, delta, theta, _, w = round_op(
            deltas, pad(psi_avg, kp), pad(state.angle.smoothed[sel], kp),
            pad(state.angle.count[sel], kp), pad(data_sizes, kp))
        if tp_specs is None:
            g_avg, delta = fl_shard_map.gather_model_sharded(
                mesh, [g_avg, delta], pspecs)
        # f32 in the region, ONE cast to the param dtype after it
        delta = treemath.tree_map(lambda d, p: d.to(p.dtype), delta, params)
        return (fl_shard_map.replicate_rows(mesh, losses, k), state.ef,
                g_avg, dots[:k], sqs[:k], sqg, theta[:k], w[:k], delta)

    def sharded_uplink(state, params, batches, sel, data_sizes, psi_avg,
                       lr):
        """The flat_sharded engine's uplink and aggregation: (losses, new
        EF, g_avg, dots, sqs, sqg, theta, w, delta), the same on every
        rank."""
        k = sel.shape[0]
        kp = fl_shard_map.padded_k(k, fl_shard_map.client_axis_size(mesh))
        deltas, losses, real = sharded_clients(params, batches, lr, k)
        flat, _ = treemath.tree_ravel_stacked(deltas)
        nreal = real.stop - real.start
        new_ef = state.ef
        if fl.error_feedback:
            flat = flat + fl_shard_map.pad_rows(state.ef[sel[real]],
                                                flat.shape[0])
        wire = transport.quantize(flat, fl.transport,
                                  group_size=fl.group_size)
        if fl.error_feedback:
            resid = (flat - transport.dequantize(wire))[:nreal]
            new_ef = state.ef.index_copy(0, sel, fl_shard_map.replicate_rows(
                mesh, resid, k))
        values = ((wire.values,) if wire.scales is None
                  else (wire.values, wire.scales))
        pad = fl_shard_map.pad_rows
        g_flat, dots, sqs, sqg, delta_flat, theta, _, w = round_ops(
            *values, pad(psi_avg, kp), segment_mask(params),
            pad(state.angle.smoothed[sel], kp),
            pad(state.angle.count[sel], kp), pad(data_sizes, kp), n=wire.n)
        unravel = treemath.unraveler(params)
        return (fl_shard_map.replicate_rows(mesh, losses, k), new_ef,
                unravel(g_flat, torch.float32), dots[:k], sqs[:k], sqg,
                theta[:k], w[:k], unravel(delta_flat))

    def uplink(state, params, batches, sel, data_sizes, psi_avg, lr):
        """The flat and tree engines' uplink and aggregation."""
        angle_state = state.angle
        deltas, losses = clients(params, batches, lr)
        new_ef = state.ef

        # ---- the uplink: ravel once, compress once to the wire ----
        if wire_2d and fl.transport != "f32":
            # the tree engine on a 2D mesh reads the blocked wire: each
            # model block quantized on its own, as flat_sharded's region
            # does (with param_specs this rank's block only)
            deltas = fl_shard_map.make_blocked_roundtrip(
                mesh, global_template(
                    params, treemath.tree_leaves(deltas)[0].shape[0]),
                specs_of(params), transport=fl.transport,
                group_size=fl.group_size,
                local=tp_specs is not None)(deltas)
        elif fl.engine == "flat" or fl.transport != "f32":
            flat, unravel = treemath.tree_ravel_stacked(deltas)
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
            g_flat = _agg_wire(psi_avg, wire)
            dots, sqs, sqg = _stats_wire(wire, g_flat, segment_mask(params))
            g_avg = unravel(g_flat, torch.float32)
        else:
            g_avg = treemath.tree_weighted_sum(deltas, psi_avg,
                                               torch.float32)
            if tp_specs is not None:
                dots, sqs, sqg = _tree_stats_tp(deltas, g_avg, params,
                                                angle_pred, mesh, tp_specs)
            else:
                dots, sqs, sqg = _tree_stats(deltas, g_avg, params,
                                             angle_pred)
        theta = weighting.instantaneous_angle(dots, sqs, sqg)

        # Eq. 9 scatter, one copy for both engines
        new_angle = _scatter_angles(angle_state, sel, theta)
        theta_sm = new_angle.smoothed[sel]
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
        return (losses, new_ef, g_avg, dots, sqs, sqg, theta, new_angle,
                theta_sm, w, delta)

    def round_fn(state: RoundState, batches, sel_idx, data_sizes):
        _check_state(fl, state)
        if mesh is not None:
            mesh.check_device(data_sizes.device)
        angle_state = state.angle
        sel = sel_idx.to(torch.int64)
        lr = _lr_at(fl, state.round)
        # ---- the downlink: the clients train from its reconstruction,
        # the aggregate lands on the uncompressed master copy ----
        params_srv = state.params
        params, new_dl, new_bcast = _broadcast(fl, state)
        down_split = None
        if fl.downlink_delta:
            # every selected client pulls version v
            v = new_bcast.head_ver
            if fl.telemetry:
                down_split = _down_byte_split(fl, param_count(params),
                                              state.bcast.ver[sel], v)
            new_bcast = new_bcast._replace(ver=new_bcast.ver.index_copy(
                0, sel, v.expand(sel.shape[0])))
        psi_avg = weighting.fedavg_weights(data_sizes)
        if sharded:
            (losses, new_ef, g_avg, dots, sqs, sqg, theta, w, delta) = (
                sharded_uplink_2d if wire_2d else sharded_uplink)(
                state, params, batches, sel, data_sizes, psi_avg, lr)
            # Eq. 9 scatter: the region computed the same float ops for
            # its weights; this is the state's bookkeeping
            new_angle = _scatter_angles(angle_state, sel, theta)
            theta_sm = new_angle.smoothed[sel]
        else:
            (losses, new_ef, g_avg, dots, sqs, sqg, theta, new_angle,
             theta_sm, w, delta) = uplink(state, params, batches, sel,
                                          data_sizes, psi_avg, lr)
        new_params = treemath.tree_add(params_srv, delta)

        # Fig. 7 divergence: (1/K) sum_i ||dF - dF_i|| with dF ~ -delta/lr
        div = torch.mean(torch.sqrt(
            torch.clamp(sqs - 2 * dots + sqg, min=0.0))) / lr
        metrics = _metrics(losses, theta, theta_sm, w, div, lr,
                           data_sizes.device)
        if fl.telemetry:
            metrics.update(_telemetry_metrics(
                fl, params, sel_idx, w, down_split=down_split,
                n=None if tp_specs is None else sum(
                    math.prod(s) for s in _global_shapes(
                        params, tp_specs,
                        fl_shard_map.model_axis_size(mesh)))))
        return state._replace(params=new_params, angle=new_angle,
                              prev_delta=g_avg, ef=new_ef, dl_ef=new_dl,
                              bcast=new_bcast,
                              round=state.round + 1), metrics

    return round_fn


def _make_buffered_round(loss_fn: Callable, fl: FLConfig,
                         delta_constraint: Optional[Callable],
                         angle_pred: Optional[Callable],
                         grad_constraint: Optional[Callable],
                         mesh=None,
                         arrival_fn: Optional[Callable] = None) -> Callable:
    """The buffered-async server tick (aggregation="buffered"), the
    reference's `_make_buffered_round`.

    One call is one server tick: the K candidates pull the current
    broadcast and train; free slots of `state.buf` admit the reports of
    candidates with no report in flight whose upload did not drop; the
    params move only on ticks where at least `buffer_m` reports have
    landed. `state.round` counts ticks, a report's `age` flushes. Every
    choice is a mask or a `torch.where` on a device flag, so a tick runs
    the same launches flush or not (flat engine: two f32 aggregations and
    one f32 statistics call over the buffer's dequantized rows, on every
    wire) and waits on nothing. With buffer_m == K and no stragglers or
    drops each masked op reduces to its sync counterpart bit for bit.

    With a mesh (engine="flat_sharded") each rank trains its rows of the
    cohort, and the admitted reports' dequantized f32 rows are broadcast
    from their owners, so every rank admits the same buffer; the flush
    (`fl_shard_map.make_buffered_flush_ops`) streams each rank's rows of
    it, the padding rows landed False. On a 2D (client x model) mesh the
    flush streams the rank's column tile of those rows (admission is
    unchanged: the global f32 buffer on every rank): N is zero-padded to
    a multiple of the model axis's size, the tile copied out contiguous
    once a flush, and the (N/M,) aggregates gathered over "model" and
    cut back to N.
    """
    clients = _clients(loss_fn, fl, delta_constraint, grad_constraint)
    segment_mask = _segment_masks(angle_pred)
    msize = fl_shard_map.model_axis_size(mesh)
    if mesh is not None:
        sharded_clients = _sharded_clients(clients, mesh)
        flush_ops = fl_shard_map.make_buffered_flush_ops(
            mesh, alpha=fl.alpha, method=fl.method, beta=fl.staleness_beta)
    stochastic = (arrival_fn is None
                  and (fl.straggle_prob > 0 or fl.dropout_prob > 0))
    m_flush = fl.buffer_m if fl.buffer_m > 0 else fl.clients_per_round
    k = fl.clients_per_round

    def round_fn(state: RoundState, batches, sel_idx, data_sizes):
        _check_state(fl, state)
        if mesh is not None:
            mesh.check_device(data_sizes.device)
        angle_state = state.angle
        dev = data_sizes.device
        sel = sel_idx.to(torch.int64)
        lr = _lr_at(fl, state.round)

        # ---- arrivals: the generator is drawn from only when the config
        # is stochastic, so a deterministic tick leaves it as the sync
        # round does ----
        if arrival_fn is not None:
            delay, drop = arrival_fn(state.round)
            delay = torch.as_tensor(delay).to(dev, torch.int32,
                                              non_blocking=True)
            drop = torch.as_tensor(drop).to(dev, torch.bool,
                                            non_blocking=True)
        elif stochastic:
            delay, drop = buffer_mod.draw_arrivals(
                state.rng, k, fl.straggle_prob, fl.straggle_max,
                fl.dropout_prob)
        else:
            delay = torch.zeros(k, dtype=torch.int32, device=dev)
            drop = torch.zeros(k, dtype=torch.bool, device=dev)

        # ---- the downlink, as in the sync round; the version rows move
        # for the admitted candidates only (admission is the pull) ----
        params_srv = state.params
        params, new_dl, new_bcast = _broadcast(fl, state)
        if mesh is not None:
            deltas, losses, real = sharded_clients(params, batches, lr, k)
            flat0, _ = treemath.tree_ravel_stacked(deltas)
            losses = fl_shard_map.replicate_rows(mesh, losses, k)
        else:
            deltas, losses = clients(params, batches, lr)

        busy = buffer_mod.population_busy(state.buf, fl.num_clients)
        admit = state.buf.free & ~busy[sel] & ~drop
        down_split = None
        if fl.downlink_delta:
            ver_sel = new_bcast.ver[sel]
            if fl.telemetry:
                # only the admitted candidates pulled, and pay bytes
                down_split = _down_byte_split(
                    fl, param_count(params), ver_sel, new_bcast.head_ver,
                    pulled=admit)
            new_bcast = new_bcast._replace(ver=new_bcast.ver.index_copy(
                0, sel, torch.where(admit, new_bcast.head_ver, ver_sel)))

        # ---- the uplink: compress to the wire, buffer the f32
        # reconstruction (sharded: of this rank's rows) ----
        if mesh is not None:
            unravel0 = treemath.unraveler(params)
            flat0 = flat0[:real.stop - real.start]
        else:
            flat0, unravel0 = treemath.tree_ravel_stacked(deltas)
            real = slice(None)
        new_ef = state.ef
        if fl.transport == "f32":
            rows = flat0
        else:
            if fl.error_feedback:
                flat0 = flat0 + state.ef[sel[real]]
            rows = transport.dequantize(transport.quantize(
                flat0, fl.transport, group_size=fl.group_size))
            if fl.error_feedback:
                # a report that was not admitted never shipped: its
                # residual stays carried
                resid = torch.where(admit[real, None], flat0 - rows,
                                    state.ef[sel[real]])
                if mesh is not None:
                    resid = fl_shard_map.replicate_rows(mesh, resid, k)
                new_ef = state.ef.index_copy(0, sel, resid)
        if mesh is not None:
            rows = fl_shard_map.replicate_rows(mesh, rows, k)
        buf = buffer_mod.admit(state.buf, admit, rows, sel, data_sizes,
                               delay)
        landed = buffer_mod.landed_mask(buf)
        num_landed = torch.sum(landed.to(torch.int32))
        do_flush = num_landed >= m_flush
        slot = buf.slot.to(torch.int64)

        # the staleness-discounted FedAvg weights of the landed rows: the
        # angle reference g (psi_avg when every row landed at age 0)
        psi_b = weighting.buffered_fedavg_weights(
            buf.sizes, buf.age, landed, fl.staleness_beta)
        if mesh is not None:
            # each rank's rows of the buffer; padding rows land False
            kp = fl_shard_map.padded_k(k, fl_shard_map.client_axis_size(
                mesh))
            pad = fl_shard_map.pad_rows
            shard = fl_shard_map.flat_client_sharding(mesh)
            values = fl_shard_map.local_block(buf.data, kp, shard)
            mvec = segment_mask(params)
            if msize > 1:  # and its column tile
                values, mvec = fl_shard_map.column_tile(mesh, values, mvec)
            g_flat, dots, sqs, sqg, delta_flat, theta, _, w = flush_ops(
                values, pad(psi_b, kp), mvec,
                pad(angle_state.smoothed[slot], kp),
                pad(angle_state.count[slot], kp), pad(buf.sizes, kp, 1.0),
                pad(buf.age, kp), pad(landed, kp, False))
            dots, sqs, theta, w = dots[:k], sqs[:k], theta[:k], w[:k]
            if msize > 1:
                n = buf.data.shape[1]
                g_flat, delta_flat = (mesh.all_gather(
                    v, axes=(fl_shard_map.MODEL_AXIS,))[:n]
                    for v in (g_flat, delta_flat))
            g_avg = unravel0(g_flat, torch.float32)
        elif fl.engine == "flat":
            g_flat = weighted_agg(psi_b, buf.data, out_dtype=torch.float32)
            dots, sqs, sqg = round_stats(buf.data, g_flat,
                                         segment_mask(params))
            g_avg = unravel0(g_flat, torch.float32)
        else:
            deltas_b = treemath.tree_unravel_stacked(deltas, buf.data,
                                                     torch.float32)
            g_avg = treemath.tree_weighted_sum(deltas_b, psi_b,
                                               torch.float32)
            dots, sqs, sqg = _tree_stats(deltas_b, g_avg, params,
                                         angle_pred)
        if mesh is None:
            theta = weighting.instantaneous_angle(dots, sqs, sqg)

        # Eq. 9 over the landed rows, kept only on a flush tick
        ang_flushed = _scatter_angles_masked(angle_state, slot, theta,
                                             landed)
        new_angle = AngleState(*(torch.where(do_flush, a, b) for a, b in
                                 zip(ang_flushed, angle_state)))
        theta_sm = new_angle.smoothed[slot]
        if mesh is not None:  # the flush region's weights and aggregate
            delta = unravel0(delta_flat)
        else:
            if fl.method == "fedadp":
                w = weighting.buffered_fedadp_weights(
                    theta_sm, buf.sizes, buf.age, landed, fl.alpha,
                    fl.staleness_beta)
            else:
                w = psi_b
            if fl.engine == "flat":
                delta_flat = (weighted_agg(w, buf.data,
                                           out_dtype=torch.float32)
                              if fl.method == "fedadp" else g_flat)
                delta = unravel0(delta_flat)
            else:
                delta = treemath.tree_map(
                    lambda d, p: d.to(p.dtype),
                    treemath.tree_weighted_sum(deltas_b, w, torch.float32),
                    params)

        # a flush applies the delta to the master params; any other tick
        # carries params and prev_delta as they were
        new_params = treemath.tree_map(
            lambda a, b: torch.where(do_flush, a, b),
            treemath.tree_add(params_srv, delta), params_srv)
        new_prev = treemath.tree_map(lambda a, b: torch.where(do_flush, a, b),
                                     g_avg, state.prev_delta)
        final_buf = buffer_mod.advance(buf, landed, do_flush)

        nl_f = torch.clamp(num_landed.to(torch.float32), min=1.0)
        div = torch.sum(torch.where(
            landed, torch.sqrt(torch.clamp(sqs - 2 * dots + sqg, min=0.0)),
            0.0)) / nl_f / lr
        metrics = _metrics(losses, theta, theta_sm, w, div, lr, dev)
        metrics.update({
            "flushed": do_flush.to(torch.int32),
            "buffer_landed": num_landed,
            "staleness": torch.sum(torch.where(landed, buf.age, 0)
                                   .to(torch.float32)) / nl_f,
        })
        if fl.telemetry:
            # attribution follows the buffer's rows (theta and weights
            # are computed over them), not this tick's candidates
            metrics.update(_telemetry_metrics(fl, params, buf.slot, w,
                                              occupied=~buf.free,
                                              down_split=down_split))
            metrics["tel/ages"] = buf.age
            metrics["tel/landed"] = landed
            metrics["tel/occupancy"] = torch.sum(~buf.free,
                                                 dtype=torch.int32)
        return state._replace(
            params=new_params, angle=new_angle, prev_delta=new_prev,
            ef=new_ef, dl_ef=new_dl, bcast=new_bcast, buf=final_buf,
            round=state.round + 1), metrics

    return round_fn


def _owned(mesh, spec: tuple) -> bool:
    """Whether this rank counts a leaf of `spec` in the round's
    statistics: its index is 0 on every axis of more than one rank that
    the leaf is replicated over, so that every element is counted once
    over the mesh."""
    from repro_torch.models import sharding

    names = {a for entry in spec for a in sharding.entry_axes(entry)}
    return all(index == 0 for axis, size, index in (
        ("data", mesh.client_size, mesh.client_index),
        ("model", mesh.model_size, mesh.model_index))
        if size > 1 and axis not in names)


def _global_count(blocks: Tree, specs: Tree, mesh) -> int:
    """The model's parameter count from this rank's blocks of it."""
    from repro_torch.models import sharding

    return sum(x.numel() * math.prod(
        mesh.shape[a] for entry in spec for a in sharding.entry_axes(entry))
        for x, spec in zip(treemath.tree_leaves(blocks),
                           treemath.tree_leaves_like(blocks, specs)))


def _make_sequential_round(loss_fn: Callable, fl: FLConfig,
                           angle_pred: Optional[Callable],
                           grad_constraint: Optional[Callable],
                           mesh=None, param_specs=None,
                           rows_over_data: bool = True) -> Callable:
    """Sequential mode: one model copy, the K clients in a Python loop.

    FedAdp needs the round's global delta before it can weight, so the
    exact round runs two passes: pass 1 trains each client and sums the
    FedAvg-weighted global delta g; pass 2 trains each client again,
    measures its angle to g through `round_stats` on a (1, N) view (one
    launch a client, with the angle filter's segment mask), and sums
    w_i * delta_i and w_i online (w_i = D_i e^{f(theta~_i)}: Eq. 11's
    softmax has one scalar denominator). `stale_angles=True` is the
    one-pass variant against the previous round's `prev_delta`. Nothing
    in the loop waits on the device.

    With `param_specs` (FSDP, on `mesh`) every tree of the round is this
    rank's blocks, each client trains inside `tp.scope(mesh,
    specs=param_specs, rows_over_data=...)`, and `round_stats` runs on
    the rank's (1, n_local) block with the segment mask times the
    ownership mask (`_owned`); one (3,) all-reduce over the mesh then
    gives each client's dot and squared norms, each element counted
    once."""
    segment_mask = _segment_masks(angle_pred)
    owner_masks: dict = {}

    def stats_mask(params) -> Optional[torch.Tensor]:
        maskv = segment_mask(params)
        if param_specs is None:
            return maskv
        dev = treemath.tree_leaves(params)[0].device
        if dev not in owner_masks:
            owned = treemath.segment_mask(params, [
                _owned(mesh, spec) for spec in
                treemath.tree_leaves_like(params, param_specs)])
            owner_masks[dev] = owned if maskv is None else owned * maskv
        return owner_masks[dev]

    def stats(d_flat, g_flat, maskv):
        dots, sqs, sqg = round_stats(d_flat[None], g_flat, maskv)
        if param_specs is None:
            return dots[0], sqs[0], sqg
        return tuple(mesh.all_reduce(torch.stack([dots[0], sqs[0], sqg]),
                                     axes=("data", "model")))

    train = local_update
    if param_specs is not None:
        from repro_torch.models import tp

        def train(*args):
            with tp.scope(mesh, specs=param_specs,
                          rows_over_data=rows_over_data):
                return local_update(*args)

    def client(params, batches, i, lr):
        return train(loss_fn, params,
                     treemath.tree_map(lambda a: a[i], batches), lr,
                     fl.prox_mu, grad_constraint)

    def round_fn(state: RoundState, batches, sel_idx, data_sizes):
        params, angle_state = state.params, state.angle
        if mesh is not None:
            mesh.check_device(treemath.tree_leaves(params)[0].device)
        sel = sel_idx.to(torch.int64)
        k = sel.shape[0]
        lr = _lr_at(fl, state.round)
        maskv = stats_mask(params)
        sizes = data_sizes.to(torch.float32)
        psi_avg = sizes / torch.sum(sizes)

        losses = None
        if not fl.stale_angles:
            # ---- pass 1: the FedAvg-weighted global delta ----
            g_ref, pass1 = init_prev_delta(params), []
            for i in range(k):
                d_i, loss = client(params, batches, i, lr)
                g_ref = treemath.tree_axpy(psi_avg[i], d_i, g_ref)
                pass1.append(loss)
                del d_i  # before the next client trains
            losses = torch.stack(pass1)
        else:
            g_ref = state.prev_delta
        # pass 2 reads g as one vector; the tree goes (each param-sized
        # tree the round holds is one more model copy)
        g_flat, _ = treemath.tree_ravel(g_ref)
        del g_ref

        # ---- pass 2 (or the one stale pass): the statistics and the
        # online weighted sum ----
        cnt = angle_state.count[sel].to(torch.float32) + 1.0
        prev_sm = angle_state.smoothed[sel]
        num, den, g_acc = init_prev_delta(params), torch.zeros(
            (), device=sizes.device), init_prev_delta(params)
        rows, pass2 = [], []
        for i in range(k):
            d_i, loss = client(params, batches, i, lr)
            d_flat, _ = treemath.tree_ravel(d_i)
            dot_i, sq_i, sqg_i = stats(d_flat, g_flat, maskv)
            theta_i = weighting.instantaneous_angle(dot_i, sq_i, sqg_i)
            sm = ((cnt[i] - 1.0) * prev_sm[i] + theta_i) / cnt[i]
            if fl.method == "fedadp":
                w_i = sizes[i] * torch.exp(weighting.gompertz(sm, fl.alpha))
            else:
                w_i = sizes[i]
            num = treemath.tree_axpy(w_i, d_i, num)
            den = den + w_i
            g_acc = treemath.tree_axpy(psi_avg[i], d_i, g_acc)
            rows.append(torch.stack([theta_i, sm, dot_i, sq_i, sqg_i]))
            pass2.append(loss)
            del d_i, d_flat  # before the next client trains
        theta, theta_sm, dots, sqs, sqgs = torch.stack(rows, dim=1)
        delta = treemath.tree_scale(num, 1.0 / torch.clamp(den, min=1e-12))
        new_params = treemath.tree_map(
            lambda p, d: (p.to(torch.float32) + d).to(p.dtype), params,
            delta)
        new_angle = _scatter_angles(angle_state, sel, theta)
        w = (weighting.fedadp_weights(theta_sm, sizes, fl.alpha)
             if fl.method == "fedadp" else psi_avg)
        div = torch.mean(torch.sqrt(
            torch.clamp(sqs - 2 * dots + sqgs, min=0.0))) / lr
        metrics = _metrics(losses if losses is not None
                           else torch.stack(pass2), theta, theta_sm, w, div,
                           lr, sizes.device)
        if fl.telemetry:
            metrics.update(_telemetry_metrics(
                fl, params, sel_idx, w, n=None if param_specs is None
                else _global_count(params, param_specs, mesh)))
        # prev_delta is pass 2's FedAvg-weighted sum, as in the reference
        return state._replace(params=new_params, angle=new_angle,
                              prev_delta=g_acc,
                              round=state.round + 1), metrics

    return round_fn
