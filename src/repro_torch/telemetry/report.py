"""Telemetry stream post-processing: the logic behind `scripts/flstat.py`.

The port's own copy of `repro/telemetry/report.py`. `summarize(events)`
turns a validated stream back into the run's headline numbers: rounds
run, rounds-to-target (recomputed from the accuracy trace alone, so a
stream is sufficient evidence for a Table-I claim), per-node
angle/weight trajectories, wire bytes, and per-span wall-clock
percentiles. `check_weight_sums` asserts the FedAdp softmax invariant
(the weights of a round sum to 1) over the node rows.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.telemetry import schema
from repro_torch.telemetry.sinks import load_events  # noqa: F401  (re-export)


def _percentile(sorted_vals, q: float) -> float:
    """Linear-interpolation percentile (numpy's default method).

    The previous `round()` on the fractional rank used banker's
    rounding, so half-valued ranks picked the lower sample for even
    positions and the upper for odd ones — p50 of [1, 2, 3, 4] came out
    2, not 2.5. Interpolating between the bracketing samples makes the
    estimate continuous in q and order-consistent across span lists.
    """
    if not sorted_vals:
        return math.nan
    pos = q * (len(sorted_vals) - 1)
    pos = min(len(sorted_vals) - 1, max(0.0, pos))
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return sorted_vals[lo]
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def rounds_to_target(events: list, target: float) -> Optional[int]:
    """First round whose (real, non-sentinel) accuracy >= target."""
    best = None
    for ev in events:
        if ev.get("event") != "round":
            continue
        acc = ev.get("accuracy")
        if acc is None or not schema.is_real_accuracy(acc):
            continue
        if acc >= target and (best is None or ev["round"] < best):
            best = ev["round"]
    return best


def node_trajectories(events: list) -> dict:
    """node id -> {"rounds": [...], "theta": [...], "theta_smoothed":
    [...], "weight": [...]} in round order."""
    out: dict = {}
    for ev in events:
        if ev.get("event") != "node":
            continue
        t = out.setdefault(ev["node"], {"rounds": [], "theta": [],
                                        "theta_smoothed": [], "weight": []})
        t["rounds"].append(ev["round"])
        t["theta"].append(ev["theta"])
        t["theta_smoothed"].append(ev["theta_smoothed"])
        t["weight"].append(ev["weight"])
    return out


def check_weight_sums(events: list, tol: float = 1e-5) -> int:
    """Assert sum_i w_i == 1 (within `tol`) for every round with node
    rows; buffered non-flush ticks (round.flushed == 0) are exempt —
    their weights are the zeros of a skipped aggregation. Returns the
    number of rounds checked; raises ValueError naming the first bad
    round."""
    flushed = {ev["round"]: ev.get("flushed")
               for ev in events if ev.get("event") == "round"}
    sums: dict = {}
    for ev in events:
        if ev.get("event") == "node":
            sums[ev["round"]] = sums.get(ev["round"], 0.0) + ev["weight"]
    checked = 0
    for rnd in sorted(sums):
        if flushed.get(rnd) == 0:
            continue
        if abs(sums[rnd] - 1.0) > tol:
            raise ValueError(
                f"round {rnd}: node weights sum to {sums[rnd]:.8f}, "
                f"expected 1 within {tol}")
        checked += 1
    return checked


def summarize(events: list, target: float = 0.85) -> dict:
    """Headline numbers of a telemetry stream (see module docstring)."""
    schema.validate_events(events)
    man = next((e for e in events if e["event"] == "manifest"), None)
    rounds = [e for e in events if e["event"] == "round"]
    accs = [(e["round"], e["accuracy"]) for e in rounds
            if e.get("accuracy") is not None]
    spans: dict = {}
    for ev in events:
        if ev["event"] == "span":
            spans.setdefault(ev["name"], []).append(ev["dur_s"])
    span_stats = {}
    for name, ds in spans.items():
        ds = sorted(ds)
        span_stats[name] = {
            "count": len(ds), "total_s": sum(ds),
            "p50_s": _percentile(ds, 0.50), "p90_s": _percentile(ds, 0.90),
            "p99_s": _percentile(ds, 0.99),
        }
    traj = node_trajectories(events)
    return {
        "manifest": man,
        "rounds": len(rounds),
        "first_round": min((e["round"] for e in rounds), default=None),
        "last_round": max((e["round"] for e in rounds), default=None),
        "evals": len(accs),
        "final_accuracy": accs[-1][1] if accs else None,
        "target_acc": target,
        "rounds_to_target": rounds_to_target(events, target),
        "nodes": sorted(traj),
        "node_trajectories": traj,
        "bytes_up": sum(e.get("bytes_up", 0) for e in rounds),
        "bytes_down": sum(e.get("bytes_down", 0) for e in rounds),
        "spans": span_stats,
    }


def format_summary(s: dict, per_node: bool = False) -> str:
    """Human-readable rendering of `summarize`'s dict."""
    man = s.get("manifest") or {}
    lines = []
    cfg_hash = man.get("config_hash")
    lines.append(
        f"run: commit={man.get('git_commit') or '?'} "
        f"jax={man.get('jax_version') or '?'} "
        f"devices={man.get('device_count')}x{man.get('device_kind') or '?'} "
        f"config={cfg_hash[:12] if cfg_hash else '?'}")
    rtt = s["rounds_to_target"]
    acc = s["final_accuracy"]
    lines.append(
        f"rounds {s['first_round']}..{s['last_round']} ({s['rounds']} run, "
        f"{s['evals']} evals) final_acc="
        f"{'n/a' if acc is None else f'{acc:.4f}'} "
        f"rounds_to_{s['target_acc']:.0%}={rtt if rtt is not None else '>'}")
    if s["bytes_up"] or s["bytes_down"]:
        lines.append(f"wire: up={int(s['bytes_up'])}B "
                     f"down={int(s['bytes_down'])}B")
    for name, st in sorted(s["spans"].items()):
        lines.append(
            f"span {name}: n={st['count']} total={st['total_s']:.3f}s "
            f"p50={st['p50_s']*1e3:.1f}ms p90={st['p90_s']*1e3:.1f}ms "
            f"p99={st['p99_s']*1e3:.1f}ms")
    if per_node:
        for node in s["nodes"]:
            t = s["node_trajectories"][node]
            n = len(t["weight"])
            lines.append(
                f"node {node}: rounds={n} "
                f"theta_sm_last={t['theta_smoothed'][-1]:.4f} "
                f"w_mean={sum(t['weight'])/n:.4f} "
                f"w_last={t['weight'][-1]:.4f}")
    return "\n".join(lines)


def oneline(s: dict) -> str:
    """One-line summary for launcher exit messages."""
    rtt = s["rounds_to_target"]
    acc = s["final_accuracy"]
    return (f"telemetry: {s['rounds']} rounds, {s['evals']} evals, "
            f"{len(s['nodes'])} nodes, final_acc="
            f"{'n/a' if acc is None else f'{acc:.4f}'}, "
            f"rounds_to_{s['target_acc']:.0%}="
            f"{rtt if rtt is not None else 'not reached'}")
