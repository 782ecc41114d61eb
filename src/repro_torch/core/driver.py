"""The federated training loop on the device: data, selection, batching,
the round, the eval, and the scanned driver.

The counterpart of `repro/core/driver.py`. The node datasets are stacked
once into device tensors (`stack_nodes`); every round draws its cohort
and each client's epoch permutation from the state's `torch.Generator`
on the device (`select_clients`, `epoch_batches`), runs the round, and
evaluates when due (`make_step_fn`). Nothing is copied from the host
between rounds. A buffered config's partial-participation cohort avoids
the clients whose report is still in flight (`select_clients_avoiding`).

The same step drives both run modes. `FedServer.step` copies each
round's metrics to the host; the scanned driver (`make_scan_runner`,
`run_rounds`) runs a block of rounds with their metrics left on the
device, stacks them, copies them to the host once a block, and checks
for early exit between blocks. It snapshots the whole RoundState at
block boundaries (`ckpt_dir=`), so a killed run restores bit for bit
(`fl.state_from_tree` + `checkpoint.io.load_latest`).

On a client mesh (`engine="flat_sharded"`) every rank runs the same
step: the same generator seed draws the same cohort and batches on every
rank, and the round leaves every rank the same state. Rank 0 writes the
checkpoints (`save_state`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import buffer as buffer_mod
from repro_torch.core import fl as fl_mod
from repro_torch.telemetry import schema as tel_schema
from repro_torch.telemetry import sinks as tel_sinks
from repro_torch.telemetry import spans as tel_spans

# the accuracy reported on rounds where the eval did not run, owned by
# the telemetry schema so that sinks and flstat mask the same constant
EVAL_SENTINEL = tel_schema.EVAL_SENTINEL


class ClientData(NamedTuple):
    """Device-resident stacked node datasets, zero-padded to the largest
    node (`sizes` keeps the true counts; padding is never sampled). `tau`
    = n_i // batch_size local steps, equal across nodes by construction."""

    x: torch.Tensor  # (C, n_max, ...) features
    y: torch.Tensor  # (C, n_max) int labels
    sizes: torch.Tensor  # (C,) int32 true per-node sample counts
    tau: int
    batch_size: int


def stack_nodes(nodes: list, batch_size: int,
                device: torch.device) -> ClientData:
    """Stack host node datasets into one ClientData on `device`. Raises
    ValueError when a node is too small for one batch or when nodes
    disagree on tau."""
    taus = [len(ds.y) // batch_size for ds in nodes]
    for i, (ds, tau) in enumerate(zip(nodes, taus)):
        if tau < 1:
            raise ValueError(
                f"node {i} has {len(ds.y)} samples but batch_size="
                f"{batch_size}: tau = {len(ds.y)}//{batch_size} = 0 local "
                "steps; lower batch_size or grow the node's dataset")
    if len(set(taus)) != 1:
        raise ValueError(
            f"nodes disagree on local steps tau = n_i//batch_size: {taus}; "
            "stacked (K, tau, B, ...) round batches admit exactly one tau")
    n_max = max(len(ds.y) for ds in nodes)

    def pad(a):
        a = np.asarray(a)
        if a.shape[0] == n_max:
            return a
        fill = np.zeros((n_max - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, fill])

    return ClientData(
        x=torch.from_numpy(np.stack([pad(ds.x) for ds in nodes])).to(device),
        y=torch.from_numpy(np.stack([pad(ds.y) for ds in nodes])).to(device),
        sizes=torch.tensor([len(ds.y) for ds in nodes], dtype=torch.int32,
                           device=device),
        tau=taus[0], batch_size=batch_size)


def select_clients(gen: torch.Generator, num_clients: int,
                   k: int) -> torch.Tensor:
    """(k,) int64 population slots for this round's cohort: the identity
    under full participation, else uniform without replacement."""
    if k >= num_clients:
        return torch.arange(num_clients, device=gen.device)
    return torch.randperm(num_clients, generator=gen, device=gen.device)[:k]


def select_clients_avoiding(gen: torch.Generator, num_clients: int, k: int,
                            busy: torch.Tensor) -> torch.Tensor:
    """(k,) int64 slots preferring clients with no report in flight: the
    uniform keys of busy clients get +1, so every free client sorts
    before every busy one and the k smallest win (busy ones come in only
    when fewer than k are free, and admission masks them out). Full
    participation is the identity, as in `select_clients`: it draws
    nothing."""
    if k >= num_clients:
        return torch.arange(num_clients, device=gen.device)
    u = torch.rand(num_clients, generator=gen, device=gen.device)
    u = torch.where(busy, u + 1.0, u)
    return torch.argsort(u)[:k]


def epoch_batches(gen: torch.Generator, data: ClientData,
                  sel: torch.Tensor):
    """One epoch of shuffled minibatches per selected client, on device:
    (xb, yb) with leaves (K, tau, B, ...).

    Uniforms are drawn for all C population rows and then indexed by
    `sel`, so a client's permutation depends only on (the generator's
    state at this round, client id), never on who else was selected.
    Ragged nodes: rows past sizes[c] get +inf and sort last."""
    count = data.tau * data.batch_size
    c, n_max = data.y.shape
    u = torch.rand((c, n_max), generator=gen, device=gen.device)
    valid = (torch.arange(n_max, device=u.device)[None]
             < data.sizes[:, None])
    u = torch.where(valid, u, torch.inf)[sel]
    idx = torch.argsort(u, dim=1)[:, :count]
    rows = sel[:, None]
    k = sel.shape[0]
    xb = data.x[rows, idx].reshape((k, data.tau, data.batch_size)
                                   + tuple(data.x.shape[2:]))
    yb = data.y[rows, idx].reshape(k, data.tau, data.batch_size)
    return xb, yb


def make_eval_fn(apply_fn: Callable, test_x, test_y, device: torch.device,
                 chunk: int = 2048) -> Callable:
    """Test accuracy on the device: params -> f32 fraction correct,
    evaluated in chunks to bound activation memory."""
    xs = torch.as_tensor(np.asarray(test_x), device=device)
    ys = torch.as_tensor(np.asarray(test_y), device=device)
    n = xs.shape[0]

    def eval_fn(params) -> torch.Tensor:
        correct = torch.zeros((), dtype=torch.int64, device=device)
        with torch.no_grad():
            for i in range(0, n, chunk):
                pred = torch.argmax(apply_fn(params, xs[i:i + chunk]), -1)
                correct += torch.sum(pred == ys[i:i + chunk])
        return correct.to(torch.float32) / n

    return eval_fn


def make_step_fn(loss_fn: Callable, fl: fl_mod.FLConfig, data: ClientData,
                 *, eval_fn: Optional[Callable] = None,
                 angle_pred: Optional[Callable] = None,
                 mesh=None, arrival_fn: Optional[Callable] = None) -> Callable:
    """One federated round on the device.

    step(state, eval_every) -> (state, metrics): select this round's
    cohort and draw each client's epoch batches from `state.rng`, run the
    round, and (when `eval_fn` is given) add metrics["accuracy"]:
    evaluated after rounds where (r+1) % eval_every == 0, EVAL_SENTINEL
    otherwise (eval_every = 0 disables it).

    With `fl.aggregation == "buffered"` a step is one server tick: under
    partial participation the cohort avoids busy clients
    (`select_clients_avoiding` over `state.buf`), and `arrival_fn` goes
    to the round (`core.server.fixed_arrival_schedule`). `mesh` (a
    `launch.mesh.ClientMesh`) goes to the round, as in
    `fl.make_round_fn`: engine="flat_sharded" needs it."""
    round_fn = fl_mod.make_round_fn(loss_fn, fl, angle_pred=angle_pred,
                                    mesh=mesh, arrival_fn=arrival_fn)
    avoid = (fl.aggregation == "buffered"
             and fl.clients_per_round < fl.num_clients)

    def step(state: fl_mod.RoundState, eval_every: int):
        if avoid:
            busy = buffer_mod.population_busy(state.buf, fl.num_clients)
            sel = select_clients_avoiding(state.rng, fl.num_clients,
                                          fl.clients_per_round, busy)
        else:
            sel = select_clients(state.rng, fl.num_clients,
                                 fl.clients_per_round)
        batches = epoch_batches(state.rng, data, sel)
        sizes = data.sizes[sel].to(torch.float32)
        state, metrics = round_fn(state, batches, sel, sizes)
        if eval_fn is not None:
            if eval_every > 0 and state.round % eval_every == 0:
                acc = eval_fn(state.params)
            else:
                acc = torch.full((), EVAL_SENTINEL, dtype=torch.float32,
                                 device=sizes.device)
            metrics = dict(metrics, accuracy=acc)
        return state, metrics

    return step


def make_scan_runner(step_fn: Callable) -> Callable:
    """A block of rounds: run_block(state, eval_every, length) -> (state,
    metrics), `length` calls of `step_fn` with every round's metrics left
    on the device and stacked over a leading round axis. Nothing in a
    block waits for the device. (The reference compiles the block as one
    `lax.scan`; here the launches of its rounds are queued back to
    back.)"""

    def run_block(state, eval_every: int, length: int):
        per_round = []
        for _ in range(length):
            state, metrics = step_fn(state, eval_every)
            per_round.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_round])
                       for k in per_round[0]}

    return run_block


def save_state(ckpt_dir: str, round_now: int, state: fl_mod.RoundState,
               keep: int = 3, mesh=None) -> str:
    """Snapshot `state` at `round_now` (`checkpoint.io.save_checkpoint`)
    and return the archive's path. On a mesh rank 0 writes (every rank
    holds the same state) and every rank waits at a barrier until it
    has, so a restore on any rank reads the finished archive."""
    path = ckpt_io.checkpoint_path(ckpt_dir, round_now)
    if mesh is None or mesh.rank == 0:
        path = ckpt_io.save_checkpoint(ckpt_dir, round_now,
                                       fl_mod.state_to_tree(state),
                                       keep=keep)
    if mesh is not None:
        mesh.barrier()
    return path


def _to_host(metrics: dict) -> dict:
    """One block's stacked device metrics as numpy: every copy is queued,
    then one wait for the device."""
    host = {k: v.to("cpu", non_blocking=True) for k, v in metrics.items()}
    tel_spans.SpanTimer.sync(metrics)
    return {k: v.numpy() for k, v in host.items()}


def run_rounds(run_block: Callable, state: fl_mod.RoundState, rounds: int,
               *, eval_every: int = 1, target_acc: Optional[float] = None,
               block: int = 8, ckpt_dir: Optional[str] = None,
               ckpt_every_blocks: int = 1, ckpt_keep: int = 3,
               sink=None, telemetry_every: int = 1,
               spans: Optional[tel_spans.SpanTimer] = None, mesh=None):
    """Blocks of rounds with host-side early exit and optional
    block-boundary checkpointing, the reference's `run_rounds`.

    Runs `block` rounds per call of `run_block` (the last block is the
    remainder); between blocks the host checks the blocks' accuracies
    against `target_acc`. rounds_to_target is the exact (r+1) of the
    first eval round at or above the target, even though the device ran
    to the end of that block. Rounds are counted from `state.round`: a
    state restored at round R resumes at R, its eval cadence stays in
    phase, and rounds_to_target reports what the uninterrupted run
    would.

    `ckpt_dir` snapshots the whole RoundState (fl.state_to_tree ->
    checkpoint.io.save_checkpoint: atomic write, `latest` pointer, the
    newest `ckpt_keep` archives kept) after every `ckpt_every_blocks`-th
    block and always at exit.

    `sink` (a `telemetry.sinks.TelemetrySink`) receives schema events at
    every block boundary: one ``round`` event per round run (the last
    block is exact-length) plus per-node rows under `telemetry="node"`;
    `telemetry_every` subsamples the emitted rounds. `spans` (a
    `telemetry.spans.SpanTimer`; one over `sink` when omitted) bounds
    each block and its host copy as a ``scan_block`` span, checkpoint
    writes as ``checkpoint``, and event emission as ``sink_emit``.
    `mesh` (a client mesh) makes rank 0 the checkpoint writer
    (`save_state`).

    Returns (state, metrics, rounds_to_target, rounds_run): metrics holds
    per-round host arrays stacked over every round run by this call
    (`rounds_run` counts them; rounds_to_target is absolute).
    """
    base = int(state.round)
    saved_at = None
    if spans is None:
        spans = tel_spans.SpanTimer(sink)

    def checkpoint(round_now):
        nonlocal saved_at
        with spans.span("checkpoint", round=round_now):
            save_state(ckpt_dir, round_now, state, ckpt_keep, mesh)
        saved_at = round_now

    blocks = []
    done = 0
    n_blocks = 0
    rounds_to_target = None
    while done < rounds and rounds_to_target is None:
        length = min(block, rounds - done)
        with spans.span("scan_block", round=base + done):
            state, ms = run_block(state, eval_every, length)
            ms = _to_host(ms)
        blocks.append(ms)
        if sink is not None:
            with spans.span("sink_emit", round=base + done):
                tel_sinks.emit_round_block(sink, ms, base + done,
                                           every=telemetry_every)
        if target_acc is not None and "accuracy" in ms:
            hit = np.flatnonzero(ms["accuracy"] >= target_acc)
            if hit.size:
                rounds_to_target = base + done + int(hit[0]) + 1
        done += length
        n_blocks += 1
        if ckpt_dir is not None and n_blocks % ckpt_every_blocks == 0:
            checkpoint(base + done)
    if ckpt_dir is not None and saved_at != base + done:
        checkpoint(base + done)
    metrics = {k: np.concatenate([m[k] for m in blocks])
               for k in blocks[0]} if blocks else {}
    return state, metrics, rounds_to_target, done
