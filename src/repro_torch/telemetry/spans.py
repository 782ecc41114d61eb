"""Host-level phase timing spans, bounded by a device sync.

The port's counterpart of `repro/telemetry/spans.py`. A round is many
asynchronous launches: the host cannot see broadcast / local training /
uplink / aggregation as separate wall-clock phases (use `profile=True`,
which wraps every span in `torch.profiler.record_function`, and a
`torch.profiler` trace for that). What the host can bound exactly is
each dispatch-granular phase of a run (stepwise rounds, scan blocks,
host copies, checkpoint writes, sink flushes):

    spans = SpanTimer(sink)
    with spans.span("scan_block", round=done):
        state, ms = run_block(state, ...)
        spans.sync(ms)            # wait for the device: bound the span

Every span emits a ``span`` event (`telemetry.schema`) and accumulates
into `totals` / `counts` / `durations` for the end-of-run percentile
summary (`scripts/flstat.py` reports p50/p90/p99 per span name).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from repro_torch.core import treemath
from repro_torch.telemetry.sinks import TelemetrySink


class SpanTimer:
    """Named wall-clock spans -> sink events + in-process aggregates."""

    def __init__(self, sink: Optional[TelemetrySink] = None,
                 profile: bool = False):
        self.sink = sink
        self.profile = profile
        self.totals: dict = {}
        self.counts: dict = {}
        self.durations: dict = {}

    @staticmethod
    def sync(x) -> None:
        """Wait for every CUDA device that holds one of `x`'s tensors (a
        tree of them; a no-op for CPU tensors): call as the LAST line
        inside a span so the span bounds device work, not dispatch."""
        for dev in {t.device for t in treemath.tree_leaves(x)
                    if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def span(self, name: str, round: Optional[int] = None):
        ctx = (torch.profiler.record_function(name) if self.profile
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        dur = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dur
        self.counts[name] = self.counts.get(name, 0) + 1
        self.durations.setdefault(name, []).append(dur)
        if self.sink is not None:
            ev = {"event": "span", "name": name, "dur_s": dur, "t0": t0}
            if round is not None:
                ev["round"] = int(round)
            self.sink.emit(ev)
