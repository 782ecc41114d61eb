"""Versioned JSONL event schema of the round-level telemetry layer.

The port's own copy of `repro/telemetry/schema.py`: the same
`SCHEMA_VERSION`, `EVAL_SENTINEL`, event types, field tables and
validators, so a stream the port writes validates under the JAX
package's readers (`scripts/flstat.py`) and the other way round.

A telemetry stream is a sequence of JSON objects (one per line). Every
event carries an ``event`` discriminator; the first event of a stream is
the run ``manifest`` (provenance: config, commit, devices, timestamp;
see `telemetry.manifest`). Readers accept only the versions they know.

Event types:

``manifest``  run provenance header (one per stream, first line)
``round``     one aggregation round/tick: scalar round metrics
``node``      one (round, node) row: the FedAdp internals (the
              instantaneous angle theta, the Eq. 9 smoothed angle, and
              the Gompertz-softmax aggregation weight); buffered mode
              adds the report's staleness ``age`` and ``landed`` flag
``span``      a host-side timing span (bounded by a device sync)
``summary``   end-of-run rollup (rounds run, target round, final acc)

This module imports neither torch nor the rest of the port: readers can
load it anywhere.
"""
from __future__ import annotations

from typing import Iterable

SCHEMA_VERSION = 1

# The eval sentinel: `driver.make_step_fn` fills metrics["accuracy"]
# with this exact value on rounds where the eval did NOT run
# ((r+1) % eval_every != 0, or eval_every == 0). It is an exact float32
# constant, so readers may compare with `==`; `is_real_accuracy` /
# `mask_accuracy` are the masking helpers: sinks and flstat never
# ingest sentinel rounds as data.
EVAL_SENTINEL = -1.0

EVENT_TYPES = ("manifest", "round", "node", "span", "summary")

# required / optional field names (beyond "event") per event type.
REQUIRED_FIELDS = {
    "manifest": ("schema", "timestamp", "jax_version", "backend",
                 "device_count"),
    "round": ("round", "loss", "lr", "divergence"),
    "node": ("round", "node", "theta", "theta_smoothed", "weight"),
    "span": ("name", "dur_s"),
    "summary": ("rounds",),
}
OPTIONAL_FIELDS = {
    "manifest": ("git_commit", "device_kind", "config", "config_hash",
                 "argv", "extra"),
    "round": ("accuracy", "weight_entropy", "bytes_up", "bytes_down",
              "bytes_down_delta", "bytes_down_full",
              "flushed", "buffer_landed", "occupancy", "staleness"),
    "node": ("age", "landed"),
    "span": ("round", "t0"),
    "summary": ("final_accuracy", "rounds_to_target", "target_acc",
                "total_bytes_up", "total_bytes_down"),
}

_NUMERIC = (int, float)


def is_real_accuracy(acc) -> bool:
    """True iff `acc` is a measured accuracy, not the eval sentinel."""
    return acc is not None and float(acc) != EVAL_SENTINEL


def mask_accuracy(acc):
    """Measured accuracy as float, or None for sentinel rounds."""
    return float(acc) if is_real_accuracy(acc) else None


def validate_event(ev: dict) -> None:
    """Raise ValueError naming the problem if `ev` violates the schema."""
    if not isinstance(ev, dict):
        raise ValueError(f"telemetry event must be a dict, got {type(ev)}")
    kind = ev.get("event")
    if kind not in EVENT_TYPES:
        raise ValueError(
            f"unknown telemetry event type {kind!r} (expected one of "
            f"{EVENT_TYPES})")
    missing = [f for f in REQUIRED_FIELDS[kind] if ev.get(f) is None]
    if missing:
        raise ValueError(f"{kind} event lacks required fields {missing}")
    if kind == "manifest" and ev["schema"] != SCHEMA_VERSION:
        raise ValueError(
            f"telemetry schema version {ev['schema']} != supported "
            f"{SCHEMA_VERSION}")
    if kind == "round":
        for f in ("loss", "lr", "divergence"):
            if not isinstance(ev[f], _NUMERIC):
                raise ValueError(f"round.{f} must be numeric, got {ev[f]!r}")
        acc = ev.get("accuracy")
        if acc is not None and float(acc) == EVAL_SENTINEL:
            raise ValueError(
                "round.accuracy carries the eval sentinel — sinks must "
                "mask non-eval rounds to null (schema.mask_accuracy)")
    if kind == "node":
        if not isinstance(ev["node"], int):
            raise ValueError(f"node.node must be int, got {ev['node']!r}")
        for f in ("theta", "theta_smoothed", "weight"):
            if not isinstance(ev[f], _NUMERIC):
                raise ValueError(f"node.{f} must be numeric, got {ev[f]!r}")
    if kind == "span" and not isinstance(ev["dur_s"], _NUMERIC):
        raise ValueError(f"span.dur_s must be numeric, got {ev['dur_s']!r}")


def validate_events(events: Iterable[dict]) -> dict:
    """Validate a whole stream; returns per-type counts.

    Enforces stream-level invariants too: the first event must be the
    manifest, and there must be exactly one manifest.
    """
    counts = {k: 0 for k in EVENT_TYPES}
    for i, ev in enumerate(events):
        validate_event(ev)
        kind = ev["event"]
        if i == 0 and kind != "manifest":
            raise ValueError(
                f"first telemetry event must be the manifest, got {kind!r}")
        if kind == "manifest" and counts["manifest"]:
            raise ValueError("telemetry stream has more than one manifest")
        counts[kind] += 1
    if counts["manifest"] == 0 and sum(counts.values()):
        raise ValueError("telemetry stream has no manifest")
    return counts
