"""Federated server loop for the paper's classification experiments.

The counterpart of `repro/core/server.py`: a thin host wrapper over
`core.driver`. The node datasets are stacked onto the device once; every
round (selection, epoch batching, the round, the eval) runs on the
device from the state's generator. Two run modes share that step:

* `run(mode="stepwise")` (and `step()`): each round's metrics are copied
  to the host as it ends;
* `run(mode="scanned")`: blocks of rounds with the metrics left on the
  device, copied once a block, with host-side early exit between blocks
  and checkpoints at block boundaries (`driver.run_rounds`).
  `run_scanned()` survives as a warn-once deprecation shim.

`save_checkpoint` and `restore` are the two halves of a kill/resume; a
`telemetry` sink streams either mode as schema events.

Every round the port runs goes through it: the parallel round on either
engine and every uplink and downlink wire, sequential mode, and the
buffered-async server (`fixed_arrival_schedule` gives it an explicit
arrival schedule).

`FedServer(..., device=None)` runs on CUDA and raises when there is no
GPU: pass device="cpu" to run on the CPU (the kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

import repro_torch
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import driver as driver_mod
from repro_torch.core import fl as fl_mod
from repro_torch.core import treemath
from repro_torch.models import small
from repro_torch.telemetry import schema as tel_schema
from repro_torch.telemetry import sinks as tel_sinks


def fixed_arrival_schedule(delays, drops):
    """An explicit arrival schedule for the buffered server: `delays`
    (T, K) int, the delay in ticks of each of tick t's K candidate
    reports (0 = on time), and `drops` (T, K) bool, the reports lost in
    transit. Returns `arrival_fn(tick) -> (delay (K,), drop (K,))` for
    `fl.make_round_fn` / `FedServer(arrival_fn=)`, which replaces the
    config's random draw. Ticks at or past T reuse the last row. The
    schedule stays on the host; the round copies a tick's row to the
    device without waiting for it."""
    delays = torch.tensor(np.asarray(delays), dtype=torch.int32)
    drops = torch.tensor(np.asarray(drops), dtype=torch.bool)
    if delays.shape != drops.shape:
        raise ValueError(
            f"delays {tuple(delays.shape)} and drops {tuple(drops.shape)} "
            "must be the same (T, K) shape")
    t_max = delays.shape[0] - 1

    def arrival_fn(tick):
        t = min(int(tick), t_max)
        return delays[t], drops[t]

    return arrival_fn


@dataclasses.dataclass
class History:
    accuracy: list
    loss: list
    divergence: list
    rounds_to_target: Optional[int]
    final_accuracy: float
    thetas: list  # per-round smoothed angles of the selected clients
    weights: list


def _seeds(seed: int) -> tuple[int, int]:
    """Two independent streams from one seed: weight init and the
    driver's selection/batching generator."""
    a, b = np.random.SeedSequence(seed).spawn(2)
    return int(a.generate_state(1)[0]), int(b.generate_state(1)[0])


class FedServer:
    """Cross-device FL simulation on one device (paper Section V)."""

    def __init__(self, model: str, fl: fl_mod.FLConfig, nodes: list, test,
                 batch_size: int, seed: int = 0, angle_pred=None, mesh=None,
                 arrival_fn=None, *, device=None):
        """The reference's parameters, by name and position (`mesh` must
        be None: no mesh engine yet, ROADMAP Queue 1 item 13), and a
        keyword-only `device`: None means CUDA (raising without a GPU),
        "cpu" the kernels' plain versions."""
        self.device = (repro_torch.default_device() if device is None
                       else torch.device(device))
        self.fl = fl
        self.nodes = nodes
        self.test = test
        self.batch_size = batch_size
        self._init_fn, self.apply_fn = small.MODELS[model]

        def loss_fn(params, batch):
            x, y = batch
            return small.classification_loss(self.apply_fn, params, x, y)

        self.data = driver_mod.stack_nodes(nodes, batch_size, self.device)
        eval_fn = driver_mod.make_eval_fn(self.apply_fn, test.x, test.y,
                                          self.device)
        self._step_fn = driver_mod.make_step_fn(
            loss_fn, fl, self.data, eval_fn=eval_fn, angle_pred=angle_pred,
            mesh=mesh, arrival_fn=arrival_fn)
        self._run_block = driver_mod.make_scan_runner(self._step_fn)
        self._seed = seed
        self.state = self._fresh_state(seed)

    def _fresh_state(self, seed: int) -> fl_mod.RoundState:
        s_init, s_drv = _seeds(seed)
        # params are drawn on the CPU, so one seed gives the same model on
        # every device
        params = self._init_fn(torch.Generator().manual_seed(s_init))
        params = {k: v.to(self.device) for k, v in params.items()}
        rng = torch.Generator(device=self.device).manual_seed(s_drv)
        return fl_mod.init_round_state(self.fl, params, seed=rng)

    def reset(self, seed: Optional[int] = None) -> None:
        """Reinitialize the RoundState (fresh params, angles, generator)."""
        self.state = self._fresh_state(self._seed if seed is None else seed)

    @property
    def params(self):
        return self.state.params

    @property
    def angle_state(self):
        return self.state.angle

    @property
    def round(self) -> int:
        return self.state.round

    def step(self, eval_every: int = 0) -> dict:
        """One round; returns host (numpy) metrics. eval_every > 0 adds
        metrics["accuracy"] after rounds where (r+1) % eval_every == 0
        (-1.0 on other rounds)."""
        self.state, metrics = self._step_fn(self.state, eval_every)
        return {k: v.detach().cpu().numpy() for k, v in metrics.items()}

    def evaluate(self) -> float:
        """Host-side test accuracy of the current master params."""
        return small.accuracy(self.apply_fn, self.state.params,
                              self.test.x, self.test.y)

    def run(self, rounds: int, target_acc: Optional[float] = None,
            eval_every: int = 1, *, mode: str = "stepwise",
            verbose: bool = False, block: int = 8,
            ckpt_dir: Optional[str] = None, ckpt_every_blocks: int = 1,
            ckpt_keep: int = 3, sink=None,
            telemetry_every: int = 1) -> History:
        """Train for `rounds` rounds; the reference's run surface.

        mode="stepwise" copies each round's metrics to the host as it
        ends (`verbose` prints the per-eval progress line).
        mode="scanned" runs the same step in blocks (`driver.run_rounds`):
        `block` rounds per block with host early exit between blocks,
        and `ckpt_dir` snapshotting the whole RoundState at block
        boundaries (see `restore` for the other half of a kill/resume).
        The two modes share the step and their History semantics match:
        per-round entries stop at rounds_to_target, which is the absolute
        round index (the eval cadence stays in phase on `state.round`
        when resuming a mid-run state).

        `sink` (a `repro_torch.telemetry` TelemetrySink) streams the run
        as schema events: the manifest first, one ``round`` event per
        round (subsampled by `telemetry_every`), per-node FedAdp rows
        when the config has `telemetry="node"`, and a ``summary`` last.
        Both modes feed the sink through `telemetry.sinks.emit_round_block`.
        """
        if mode not in ("stepwise", "scanned"):
            raise ValueError(
                f"unknown mode {mode!r} (expected 'stepwise' or 'scanned')")
        if sink is not None:
            tel_sinks.emit_manifest(sink, self.fl)
        start = self.state.round
        if mode == "stepwise":
            hist = History([], [], [], None, 0.0, [], [])
            for r in range(rounds):
                m = self.step(eval_every=eval_every)
                self._append(hist, m)
                if sink is not None:
                    tel_sinks.emit_round_block(sink, m, start + r,
                                               every=telemetry_every)
                acc = float(m["accuracy"])
                if tel_schema.is_real_accuracy(acc):
                    hist.accuracy.append(acc)
                    if verbose:
                        print(f"round {r + 1:4d} loss {float(m['loss']):.4f} "
                              f"acc {acc:.4f}")
                    if (target_acc and acc >= target_acc
                            and hist.rounds_to_target is None):
                        hist.rounds_to_target = start + r + 1
                        break
        else:
            self.state, ms, rtt, ran = driver_mod.run_rounds(
                self._run_block, self.state, rounds, eval_every=eval_every,
                target_acc=target_acc, block=block, ckpt_dir=ckpt_dir,
                ckpt_every_blocks=ckpt_every_blocks, ckpt_keep=ckpt_keep,
                sink=sink, telemetry_every=telemetry_every)
            hist = History([], [], [], rtt, 0.0, [], [])
            stop = rtt - start if rtt is not None else ran
            for r in range(stop):
                self._append(hist, {k: v[r] for k, v in ms.items()})
                acc = float(ms["accuracy"][r])
                if tel_schema.is_real_accuracy(acc):
                    hist.accuracy.append(acc)
        hist.final_accuracy = hist.accuracy[-1] if hist.accuracy else 0.0
        if sink is not None:
            tel_sinks.emit_summary(
                sink, rounds=self.state.round - start,
                final_accuracy=hist.final_accuracy or None,
                rounds_to_target=hist.rounds_to_target,
                target_acc=target_acc)
        return hist

    _warned_run_scanned = False

    def run_scanned(self, rounds: int, target_acc: Optional[float] = None,
                    eval_every: int = 1, block: int = 8,
                    ckpt_dir: Optional[str] = None,
                    ckpt_every_blocks: int = 1,
                    ckpt_keep: int = 3) -> History:
        """Deprecated shim: use `run(..., mode="scanned")`."""
        if not FedServer._warned_run_scanned:
            warnings.warn(
                "FedServer.run_scanned(...) is deprecated; use "
                "FedServer.run(..., mode='scanned')",
                DeprecationWarning, stacklevel=2)
            FedServer._warned_run_scanned = True
        return self.run(rounds, target_acc, eval_every, mode="scanned",
                        block=block, ckpt_dir=ckpt_dir,
                        ckpt_every_blocks=ckpt_every_blocks,
                        ckpt_keep=ckpt_keep)

    def save_checkpoint(self, ckpt_dir: str, keep: int = 3) -> str:
        """Snapshot the current RoundState into `ckpt_dir` (atomic write,
        `latest` pointer), keyed by the absolute round index."""
        return ckpt_io.save_checkpoint(
            ckpt_dir, self.round, fl_mod.state_to_tree(self.state),
            keep=keep)

    def restore(self, source: str) -> int:
        """Resume from a checkpoint: `source` is a checkpoint directory
        (the `latest` pointer is followed) or a single .npz path. The
        restored RoundState is validated against, and elastically
        re-sized to, this server's config (`fl.state_from_tree`, on this
        server's device), and its params against this server's model.
        Returns the absolute round index training resumes from."""
        if os.path.isdir(source):
            loaded = ckpt_io.load_latest(source)
            if loaded is None:
                raise FileNotFoundError(
                    f"no checkpoint found in directory {source!r}")
            _, tree = loaded
        else:
            tree = ckpt_io.load(source)
        state = fl_mod.state_from_tree(self.fl, tree, device=self.device)

        def layout(params):
            return [(p, tuple(a.shape), a.dtype) for p, a in
                    zip(treemath.tree_paths(params),
                        treemath.tree_leaves(params))]

        cur, new = layout(self.state.params), layout(state.params)
        if cur != new:
            raise ValueError(
                "checkpoint params do not match this server's model "
                f"(got {new}, want {cur})")
        self.state = state
        return self.round

    @staticmethod
    def _append(hist: History, m: dict) -> None:
        hist.loss.append(float(m["loss"]))
        hist.divergence.append(float(m["divergence"]))
        hist.thetas.append(np.asarray(m["theta_smoothed"]))
        hist.weights.append(np.asarray(m["weights"]))
