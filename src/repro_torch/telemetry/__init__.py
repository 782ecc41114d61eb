"""Round-level telemetry: per-node contribution traces, phase timing
spans, and pluggable sinks. The port's counterpart of `repro.telemetry`,
with the same schema, so the JAX package's readers read its streams.

* **Round metrics**: `FLConfig(telemetry="node")` makes every round's
  metrics carry the per-node internals (``tel/*`` keys: node
  attribution, cohort mask, weight entropy, wire bytes; buffered ticks
  add staleness ages, the landed mask and occupancy), computed on the
  device. With the default ``telemetry=None`` the round never reaches
  that code: the same metrics and the same kernel launches as without it.
* **Sinks** (`telemetry.sinks`): JSONL, CSV and in-memory;
  `emit_round_block` adapts a block of host metrics to schema events.
* **Spans** (`telemetry.spans`): `SpanTimer`, host phase timing bounded
  by a device sync, with optional `torch.profiler` annotations.
* **Schema** (`telemetry.schema`): the versioned event contract and the
  eval sentinel `EVAL_SENTINEL`.
* **Manifest** (`telemetry.manifest`): run provenance.
* **Report** (`telemetry.report`): summaries, rounds-to-target from the
  stream alone, weight-sum checks.
"""
from repro_torch.telemetry import (  # noqa: F401
    manifest,
    report,
    schema,
    sinks,
    spans,
)
from repro_torch.telemetry.manifest import run_manifest  # noqa: F401
from repro_torch.telemetry.schema import (  # noqa: F401
    EVAL_SENTINEL,
    SCHEMA_VERSION,
)
from repro_torch.telemetry.sinks import (  # noqa: F401
    CSVSink,
    JSONLSink,
    MemorySink,
    TelemetrySink,
    emit_manifest,
    emit_round_block,
    emit_summary,
    load_events,
)
from repro_torch.telemetry.spans import SpanTimer  # noqa: F401
