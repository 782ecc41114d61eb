"""Federated server loop for the paper's classification experiments.

The counterpart of `repro/core/server.py`, stepwise mode: a thin host
wrapper over `core.driver`. The node datasets are stacked onto the device
once; every round (selection, epoch batching, the round, the eval) runs
on the device from the state's generator.

Every round the port runs goes through it: the parallel round on either
engine and every uplink and downlink wire, sequential mode, and the
buffered-async server (`fixed_arrival_schedule` gives it an explicit
arrival schedule).

`FedServer(..., device=None)` runs on CUDA and raises when there is no
GPU: pass device="cpu" to run on the CPU (the kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

import repro_torch
from repro_torch.core import driver as driver_mod
from repro_torch.core import fl as fl_mod
from repro_torch.models import small


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
                 batch_size: int, seed: int = 0, angle_pred=None,
                 device=None, arrival_fn=None):
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
            arrival_fn=arrival_fn)
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
            verbose: bool = False, ckpt_dir: Optional[str] = None,
            sink=None) -> History:
        """Train for `rounds` rounds, one step per round, stopping at the
        first eval that reaches `target_acc` (rounds_to_target is the
        absolute round index)."""
        if mode == "scanned":
            raise NotImplementedError(
                "run(mode='scanned') is not ported yet (ROADMAP Queue 1 "
                "item 6)")
        if mode != "stepwise":
            raise ValueError(
                f"unknown mode {mode!r} (expected 'stepwise' or 'scanned')")
        if ckpt_dir is not None:
            raise NotImplementedError(
                "checkpointing is not ported yet (ROADMAP Queue 1 item 12)")
        if sink is not None:
            raise NotImplementedError(
                "telemetry sinks are not ported yet (ROADMAP Queue 1 item "
                "12)")
        start = self.state.round
        hist = History([], [], [], None, 0.0, [], [])
        for r in range(rounds):
            m = self.step(eval_every=eval_every)
            self._append(hist, m)
            acc = float(m["accuracy"])
            if acc != driver_mod.EVAL_SENTINEL:
                hist.accuracy.append(acc)
                if verbose:
                    print(f"round {r + 1:4d} loss {float(m['loss']):.4f} "
                          f"acc {acc:.4f}")
                if target_acc and acc >= target_acc:
                    hist.rounds_to_target = start + r + 1
                    break
        hist.final_accuracy = hist.accuracy[-1] if hist.accuracy else 0.0
        return hist

    @staticmethod
    def _append(hist: History, m: dict) -> None:
        hist.loss.append(float(m["loss"]))
        hist.divergence.append(float(m["divergence"]))
        hist.thetas.append(np.asarray(m["theta_smoothed"]))
        hist.weights.append(np.asarray(m["weights"]))
