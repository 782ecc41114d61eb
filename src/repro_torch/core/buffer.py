"""The report buffer of the buffered-async server, on the device.

The port's counterpart of `repro/core/buffer.py`. With
`FLConfig(aggregation="buffered")` the server keeps K slots (rows of a
(K, N) f32 buffer plus per-row bookkeeping, `ReportBuffer`, carried in
`fl.RoundState.buf`). Every tick, free slots admit a fresh client's
dequantized report with a simulated arrival delay (`draw_arrivals`, or
an explicit schedule, `core.server.fixed_arrival_schedule`); a dropped
report is never admitted and its slot stays free. A report lands when
its delay has run out, and the server flushes once at least `buffer_m`
reports have landed; rows that did not land age by one model version a
flush.

Every step is a mask (no shape depends on the data and nothing waits
for the host), so a tick runs the same launches whether it flushes or
not. With `buffer_m == K` and no stragglers or drops every tick admits,
lands and flushes the whole cohort at age 0: bit for bit the sync round.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

import repro_torch


class ReportBuffer(NamedTuple):
    """Per-slot state of the in-flight reports (K = clients_per_round
    rows), all on the state's device."""

    data: torch.Tensor  # (K, N) f32: dequantized report deltas
    slot: torch.Tensor  # (K,) int32: population slot of the row's client
    sizes: torch.Tensor  # (K,) f32: report data sizes D_i
    age: torch.Tensor  # (K,) int32: model versions since the pull
    wait: torch.Tensor  # (K,) int32: ticks until it lands (0 = landed)
    free: torch.Tensor  # (K,) bool: the row is empty


def init_report_buffer(k: int, n: int, device=None) -> ReportBuffer:
    """An empty K-slot buffer over N-wide rows (every row free), on
    `device` (CUDA when None: raises without a GPU)."""
    device = repro_torch.default_device() if device is None else device
    return ReportBuffer(
        data=torch.zeros((k, n), dtype=torch.float32, device=device),
        slot=torch.zeros((k,), dtype=torch.int32, device=device),
        sizes=torch.ones((k,), dtype=torch.float32, device=device),
        age=torch.zeros((k,), dtype=torch.int32, device=device),
        wait=torch.zeros((k,), dtype=torch.int32, device=device),
        free=torch.ones((k,), dtype=torch.bool, device=device),
    )


def population_busy(buf: ReportBuffer, num_clients: int) -> torch.Tensor:
    """(num_clients,) bool: clients with a report in flight. Free rows
    carry stale slot ids; they are routed to a spare last entry that is
    cut off."""
    idx = torch.where(buf.free, num_clients, buf.slot).to(torch.int64)
    busy = torch.zeros(num_clients + 1, dtype=torch.bool,
                       device=buf.free.device).index_fill(0, idx, True)
    return busy[:num_clients]


def draw_arrivals(gen: torch.Generator, k: int, straggle_prob: float,
                  straggle_max: int, dropout_prob: float):
    """This tick's arrivals of K candidate reports, drawn from `gen`:
    (delay (K,) int32, drop (K,) bool). A straggler's delay is uniform in
    {1..straggle_max}; `straggle_max` < 1 means no straggler at all. The
    three draws are taken whatever the probabilities, so the generator
    advances the same way for every config and the drop stream does not
    depend on whether straggling is on."""
    dev = gen.device
    drop = torch.rand(k, generator=gen, device=dev) < dropout_prob
    straggle = torch.rand(k, generator=gen, device=dev) < straggle_prob
    delay = torch.randint(1, max(straggle_max, 1) + 1, (k,), generator=gen,
                          device=dev, dtype=torch.int32)
    if straggle_max < 1:
        return torch.zeros(k, dtype=torch.int32, device=dev), drop
    return torch.where(straggle, delay, 0).to(torch.int32), drop


def admit(buf: ReportBuffer, admit_mask: torch.Tensor, rows: torch.Tensor,
          sel_idx: torch.Tensor, data_sizes: torch.Tensor,
          delay: torch.Tensor) -> ReportBuffer:
    """Write this tick's admitted candidate reports into their rows;
    occupied rows keep their report."""
    return ReportBuffer(
        data=torch.where(admit_mask[:, None], rows, buf.data),
        slot=torch.where(admit_mask, sel_idx.to(torch.int32), buf.slot),
        sizes=torch.where(admit_mask, data_sizes.to(torch.float32),
                          buf.sizes),
        age=torch.where(admit_mask, 0, buf.age),
        wait=torch.where(admit_mask, delay.to(torch.int32), buf.wait),
        free=buf.free & ~admit_mask,
    )


def landed_mask(buf: ReportBuffer) -> torch.Tensor:
    """(K,) bool: occupied rows whose report has arrived."""
    return ~buf.free & (buf.wait <= 0)


def advance(buf: ReportBuffer, landed: torch.Tensor,
            do_flush: torch.Tensor) -> ReportBuffer:
    """End-of-tick bookkeeping: flushed rows free up, surviving occupied
    rows age by one version when a flush moved the params, and waits tick
    down."""
    new_free = buf.free | (landed & do_flush)
    return buf._replace(
        free=new_free,
        age=torch.where(~new_free & do_flush, buf.age + 1, buf.age),
        wait=torch.where(new_free, 0,
                         torch.clamp(buf.wait - 1, min=0)).to(torch.int32),
    )
