"""Run manifest: the provenance header every telemetry stream carries.

The port's counterpart of `repro/telemetry/manifest.py`. `run_manifest()`
collects what is needed to compare two streams across commits and
machines: the telemetry schema version, an ISO-8601 UTC timestamp, the
git commit of the working tree (best-effort), the device topology
(backend, count, kind) and, when a config is given, its JSON-safe dict
plus a stable sha256 hash, so "same config?" is one string comparison.

The schema requires `jax_version`; the port has no jax, so it writes the
reference's own fallback, "unavailable". `backend` uses the names
`jax.default_backend()` uses ("gpu" or "cpu"), and the torch and CUDA
versions go under `extra`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
from datetime import datetime, timezone
from typing import Any, Optional

from repro_torch.telemetry import schema


def git_commit(cwd: Optional[str] = None) -> Optional[str]:
    """Current commit hash (with a ``-dirty`` suffix when the tree has
    uncommitted changes), or None outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10)
        if out.returncode != 0:
            return None
        commit = out.stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=10)
        if dirty.returncode == 0 and dirty.stdout.strip():
            commit += "-dirty"
        return commit
    except (OSError, subprocess.SubprocessError):
        return None


def config_dict(cfg: Any) -> Any:
    """A JSON-safe view of a config (dataclasses become dicts)."""
    if cfg is None:
        return None
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    return cfg


def config_hash(cfg: Any) -> Optional[str]:
    """Stable sha256 of the config's sorted-key JSON (None for None)."""
    d = config_dict(cfg)
    if d is None:
        return None
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def _devices() -> tuple[dict, dict]:
    """(the device fields of the manifest, the versions for `extra`)."""
    import torch

    versions = {"torch_version": torch.__version__,
                "cuda_version": torch.version.cuda}
    if torch.cuda.is_available():
        return {"backend": "gpu", "device_count": torch.cuda.device_count(),
                "device_kind": torch.cuda.get_device_name(0)}, versions
    return {"backend": "cpu", "device_count": 1,
            "device_kind": "cpu"}, versions


def run_manifest(cfg: Any = None, extra: Optional[dict] = None) -> dict:
    """The ``manifest`` telemetry event (see `telemetry.schema`)."""
    devices, versions = _devices()
    return {
        "event": "manifest",
        "schema": schema.SCHEMA_VERSION,
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "git_commit": git_commit(os.path.dirname(os.path.abspath(__file__))),
        "jax_version": "unavailable",
        **devices,
        "config": config_dict(cfg),
        "config_hash": config_hash(cfg),
        "extra": {**versions, **(extra or {})},
    }
