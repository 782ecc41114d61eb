"""Pluggable telemetry sinks plus the metrics -> events adapter.

The port's own copy of `repro/telemetry/sinks.py`. A sink is anything
with ``emit(event: dict)`` and ``close()`` (`TelemetrySink` protocol).
Three implementations ship:

* `JSONLSink(path)`: the durable format, one JSON object per line,
  manifest first (`scripts/flstat.py` reads it back).
* `CSVSink(path)`: flat per-node rows (round scalars repeated per row)
  for spreadsheet-shaped consumers.
* `MemorySink()`: an in-process list, the test surface.

`emit_round_block` is the one adapter from the rounds' host (numpy)
metrics to schema events: a block stacked over a leading round axis
(`driver.run_rounds`) or one stepwise round (`FedServer.step`). Both run
modes go through it, so their streams compare event for event. It reads
the metrics every round carries (loss, theta, theta_smoothed, weights,
...) plus the ``tel/*`` keys of `FLConfig(telemetry="node")`, and masks
the eval sentinel (`schema.EVAL_SENTINEL`) to None.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.telemetry import manifest as manifest_mod
from repro_torch.telemetry import schema


@runtime_checkable
class TelemetrySink(Protocol):
    def emit(self, event: dict) -> None: ...

    def close(self) -> None: ...


class MemorySink:
    """Keeps every event in `self.events` (tests, benches)."""

    def __init__(self):
        self.events: list = []
        self.closed = False

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        self.closed = True

    def of_type(self, kind: str) -> list:
        return [e for e in self.events if e.get("event") == kind]


class JSONLSink:
    """One JSON object per line; the file opens lazily on first emit."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def emit(self, event: dict) -> None:
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "w")
        self._fh.write(json.dumps(event, default=_json_default) + "\n")

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class CSVSink:
    """Flat per-node rows (plus accuracy/loss repeated from the round).

    Spans/manifest/summary don't fit a rectangular file and are skipped;
    use JSONL for the full stream.
    """

    COLUMNS = ("round", "node", "theta", "theta_smoothed", "weight",
               "age", "landed", "loss", "accuracy")

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._writer = None
        self._round_ctx: dict = {}

    def emit(self, event: dict) -> None:
        kind = event.get("event")
        if kind == "round":
            self._round_ctx = {"loss": event.get("loss"),
                               "accuracy": event.get("accuracy")}
            return
        if kind != "node":
            return
        if self._writer is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._fh, self.COLUMNS,
                                          extrasaction="ignore")
            self._writer.writeheader()
        self._writer.writerow({**self._round_ctx, **event})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _json_default(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not JSON-serializable: {type(x)}")


def load_events(path: str) -> list:
    """Read a JSONL telemetry stream back into a list of event dicts."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def emit_manifest(sink: TelemetrySink, cfg=None,
                  extra: Optional[dict] = None) -> None:
    """Write the run manifest as the stream's first event (idempotent —
    a sink shared by warmup + run still gets exactly one manifest)."""
    if getattr(sink, "_manifest_done", False):
        return
    sink.emit(manifest_mod.run_manifest(cfg, extra))
    sink._manifest_done = True


def emit_summary(sink: TelemetrySink, *, rounds: int,
                 final_accuracy: Optional[float] = None,
                 rounds_to_target: Optional[int] = None,
                 target_acc: Optional[float] = None) -> None:
    ev = {"event": "summary", "rounds": int(rounds)}
    if final_accuracy is not None:
        ev["final_accuracy"] = float(final_accuracy)
    if rounds_to_target is not None:
        ev["rounds_to_target"] = int(rounds_to_target)
    if target_acc is not None:
        ev["target_acc"] = float(target_acc)
    sink.emit(ev)


# metric key -> round-event field for scalars that ride along verbatim.
_ROUND_SCALARS = (
    ("loss", "loss"), ("lr", "lr"), ("divergence", "divergence"),
    ("tel/weight_entropy", "weight_entropy"),
    ("tel/bytes_up", "bytes_up"), ("tel/bytes_down", "bytes_down"),
    ("tel/bytes_down_delta", "bytes_down_delta"),
    ("tel/bytes_down_full", "bytes_down_full"),
    ("flushed", "flushed"), ("buffer_landed", "buffer_landed"),
    ("tel/occupancy", "occupancy"), ("staleness", "staleness"),
)
_INT_FIELDS = {"flushed", "buffer_landed", "occupancy", "bytes_up",
               "bytes_down", "bytes_down_delta", "bytes_down_full"}


def emit_round_block(sink: TelemetrySink, metrics: dict, start_round: int,
                     every: int = 1) -> int:
    """Emit round + per-node events for a block of rounds.

    `metrics` is a host-side (numpy) dict as `driver.run_rounds` returns
    it (every value stacked over a leading round axis) or as a single
    stepwise `FedServer.step` returns it (scalars / (K,) rows, then
    treated as a 1-round block). Rounds are ABSOLUTE: the block covers
    rounds ``start_round+1 .. start_round+R`` (post-round indices, the
    same convention as ``rounds_to_target``). `every` subsamples: only
    rounds with (absolute round) % every == 0 emit (1 = all).

    Per-node events need the engines' ``tel/nodes`` attribution row
    (`FLConfig(telemetry="node")`); without it only round events emit.
    Returns the number of rounds emitted.
    """
    ms = {k: np.asarray(v) for k, v in metrics.items()}
    if ms["loss"].ndim == 0:  # single stepwise round -> 1-round block
        ms = {k: v[None] for k, v in ms.items()}
    r_total = ms["loss"].shape[0]
    nodes = ms.get("tel/nodes")
    emitted = 0
    for r in range(r_total):
        rnd = start_round + r + 1
        if every > 1 and rnd % every:
            continue
        ev = {"event": "round", "round": rnd}
        for key, field in _ROUND_SCALARS:
            if key in ms:
                v = ms[key][r]
                ev[field] = int(v) if field in _INT_FIELDS else float(v)
        if "accuracy" in ms:
            ev["accuracy"] = schema.mask_accuracy(ms["accuracy"][r])
        sink.emit(ev)
        emitted += 1
        if nodes is None:
            continue
        ages = ms.get("tel/ages")
        landed = ms.get("tel/landed")
        for j, node in enumerate(np.asarray(nodes[r]).tolist()):
            nev = {
                "event": "node", "round": rnd, "node": int(node),
                "theta": float(ms["theta"][r][j]),
                "theta_smoothed": float(ms["theta_smoothed"][r][j]),
                "weight": float(ms["weights"][r][j]),
            }
            if ages is not None:
                nev["age"] = int(ages[r][j])
            if landed is not None:
                nev["landed"] = bool(landed[r][j])
            sink.emit(nev)
    return emitted
