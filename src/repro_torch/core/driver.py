"""The federated training step on the device: data, selection, batching,
the round, and the eval.

The counterpart of `repro/core/driver.py` for the stepwise path. The
node datasets are stacked once into device tensors (`stack_nodes`); every
round draws its cohort and each client's epoch permutation from the
state's `torch.Generator` on the device (`select_clients`,
`epoch_batches`), runs the round, and evaluates when due
(`make_step_fn`). Nothing is copied from the host between rounds. A
buffered config's partial-participation cohort avoids the clients whose
report is still in flight (`select_clients_avoiding`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import buffer as buffer_mod
from repro_torch.core import fl as fl_mod

# the accuracy reported on rounds where the eval did not run (the
# reference's telemetry.schema.EVAL_SENTINEL)
EVAL_SENTINEL = -1.0


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
                 arrival_fn: Optional[Callable] = None) -> Callable:
    """One federated round on the device.

    step(state, eval_every) -> (state, metrics): select this round's
    cohort and draw each client's epoch batches from `state.rng`, run the
    round, and (when `eval_fn` is given) add metrics["accuracy"]:
    evaluated after rounds where (r+1) % eval_every == 0, EVAL_SENTINEL
    otherwise (eval_every = 0 disables it).

    With `fl.aggregation == "buffered"` a step is one server tick: under
    partial participation the cohort avoids busy clients
    (`select_clients_avoiding` over `state.buf`), and `arrival_fn` goes
    to the round (`core.server.fixed_arrival_schedule`)."""
    round_fn = fl_mod.make_round_fn(loss_fn, fl, angle_pred=angle_pred,
                                    arrival_fn=arrival_fn)
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
                acc = torch.tensor(EVAL_SENTINEL, device=sizes.device)
            metrics = dict(metrics, accuracy=acc)
        return state, metrics

    return step
