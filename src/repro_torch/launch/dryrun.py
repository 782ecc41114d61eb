"""Dry run: build every (arch x shape x mesh) step on the meta device
and report whether it fits a cluster of H100s, per device. The
counterpart of `repro/launch/dryrun.py`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --budget-s 900 --out results/dryrun.jsonl

The mesh is `make_production_mesh`: "32x8" (256 cards) or "2x32x8"
(512). A combo's step comes from its builder (`launch/steps.py`), whose
arguments are meta tensors at the global shapes, and runs once under
`launch.optrace.OpTrace`: nothing is allocated, and every op (the
backward and the recompute included) is recorded. A record holds the
reference's keys, per device, as one rank runs it ("partition":
"rank"), for every family of the registry. The step is built on
`launch.mesh.make_trace_mesh` at the production shape and rank 0
("2x32x8" as (64, 8), the pods on "data", as `launch.mesh.world_mesh`
runs them), each argument cut to the rank's
block (`steps.rank_blocks`), and one rank's program runs: its own ops,
and its collectives through the mesh, which records them and moves
nothing (`mesh.recording()`).

  * memory.argument_bytes / output_bytes — the rank's arguments and
    outputs (each `NamedSpec.shard_shape`); alias_bytes — the outputs
    that are arguments written in place (the decode cache). The
    parallel round's rank reads its own clients' rows of a batch the
    launcher hands it whole; argument_bytes counts those rows, and
    `held_argument_bytes` the arguments as the rank is handed them;
  * memory.temp_bytes — the rank's traced peak of live allocated bytes
    less its new outputs (XLA's sense: scratch beside the outputs);
  * flops, bytes_accessed, scoped.{flops, hbm_bytes} — the rank's trace;
    a hand-written kernel's own reads and writes are outside aten, on
    the card as on meta, where its wrapper allocates its outputs only;
  * collectives, scoped.collectives — the rank's collectives by the
    reference's keys and byte convention (`hlo.collective_bytes`: result
    bytes): all-reduce its tensor, all-gather the gathered result,
    reduce-scatter the block kept, and the port's own broadcast its
    tensor; "total", "count", and "by_scope": the same per scope ("tp"
    the model's, "fsdp" the params' and the loss's over "data", "round"
    the round's own).

`step_record` ("partition": "ideal") traces a step built on an
abstract mesh whole, as one program: the arguments and outputs per
device from the specs; temp, flops and bytes the whole step's (under
"global") over the device count; "collectives" {} with `IDEAL_NOTE`.
The sweep does not use it; `chip_smoke.py`'s launch phase does, on a
(1, 1) mesh, where the one program is the device's.

Both: live_bytes = arguments + outputs + temp - alias, the reference's
live bytes a device; fits = live_bytes within one card's memory;
build_s — the builder plus the traced run (the reference's compile_s).

It exits 1 if any combo failed; a combo that runs past `--budget-s` is
a failure with that cause.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import shapes as shapes_mod
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import optrace, steps
from repro_torch.launch.mesh import (HBM_BYTES, make_production_mesh,
                                     make_trace_mesh)

IDEAL_NOTE = ("the whole step is traced as one program, which issues no "
              "collective")


def mesh_name(multi_pod: bool) -> str:
    return "2x32x8" if multi_pod else "32x8"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _shard_bytes(spec, x: torch.Tensor) -> int:
    n = 1
    for d in spec.shard_shape(tuple(x.shape)):
        n *= d
    return n * x.element_size()


def _memory(arg_pairs, out_pairs, peak: int, bytes_of) -> dict:
    """The record's memory figures from the (spec, tensor) pairs of the
    arguments and outputs, each counted by `bytes_of(spec, x)`, and the
    trace's peak."""
    arg_storages = {id(x.untyped_storage()) for _, x in arg_pairs}
    aliased = [id(x.untyped_storage()) in arg_storages for _, x in out_pairs]
    new_out = sum(_nbytes(x) for (_, x), a in zip(out_pairs, aliased)
                  if not a)
    return {
        "argument_bytes": sum(bytes_of(s, x) for s, x in arg_pairs),
        "output_bytes": sum(bytes_of(s, x) for s, x in out_pairs),
        "temp_bytes": max(peak - new_out, 0),
        "alias_bytes": sum(bytes_of(s, x) for (s, x), a
                           in zip(out_pairs, aliased) if a),
    }


def _live(memory: dict) -> int:
    return (memory["argument_bytes"] + memory["output_bytes"]
            + memory["temp_bytes"] - memory["alias_bytes"])


def step_record(fn, args, in_specs, out_specs, mesh, *,
                budget_s: float = 0.0) -> dict:
    """Run `fn(*args)` (meta tensors at the global shapes) once under the
    op trace as one program; the per-device figures of the step on
    `mesh` by the ideal partition (module docstring)."""
    arg_pairs = steps.spec_leaves(in_specs, args)
    with optrace.OpTrace(budget_s=budget_s, keep_ops=False) as trace:
        out = fn(*args)
    scoped = optrace.analyze(trace)
    devices = mesh.size
    memory = _memory(arg_pairs, steps.spec_leaves(out_specs, out),
                     trace.peak, _shard_bytes)
    temp_global = memory["temp_bytes"]
    memory["temp_bytes"] = temp_global // devices
    live = _live(memory)
    return {
        "devices": devices,
        "partition": "ideal",
        "memory": memory,
        "live_bytes": live,
        "fits": live <= HBM_BYTES,
        "global": {"flops": scoped["flops"],
                   "bytes_accessed": scoped["hbm_bytes"],
                   "temp_bytes": temp_global,
                   "peak_bytes": trace.peak},
        "flops": scoped["flops"] / devices,
        "bytes_accessed": scoped["hbm_bytes"] / devices,
        "collectives": {},
        "collectives_note": IDEAL_NOTE,
        "scoped": {"flops": scoped["flops"] / devices,
                   "hbm_bytes": scoped["hbm_bytes"] / devices,
                   "collectives": {},
                   "unknown_trip_loops": scoped["unknown_trip_loops"]},
        "ops": scoped["ops"],
    }


def _result_bytes(c, mesh) -> int:
    """The bytes of one recorded collective (`launch.mesh.Collective`)
    by the reference's convention, its result's: an all-gather's gathered
    tensor, a reduce-scatter's kept block, the tensor of the others."""
    n = mesh.axes_size(c.axes)
    if c.op == "all_gather":
        return c.nbytes * n
    if c.op == "reduce_scatter":
        return c.nbytes // n
    return c.nbytes


def _histogram(entries, mesh) -> dict:
    out: dict = {}
    for c in entries:
        key = optrace.COLLECTIVES[c.op]
        out[key] = out.get(key, 0) + _result_bytes(c, mesh)
    out["total"] = sum(out.values())
    out["count"] = len(entries)
    return out


def collectives_of(log: list, mesh) -> dict:
    """A `mesh.recording()` log as the record's collectives: result bytes
    by the reference's keys, "total", "count", and "by_scope" the same
    for each scope ("round" for the collectives outside any)."""
    scopes: dict = {}
    for c in log:
        scopes.setdefault(c.scope or "round", []).append(c)
    return {**_histogram(log, mesh),
            "by_scope": {s: _histogram(e, mesh)
                         for s, e in sorted(scopes.items())}}


def rank_record(fn, args, in_specs, out_specs, mesh, *,
                whole_batch: bool = False, budget_s: float = 0.0) -> dict:
    """Cut `args` (meta, the global shapes) to this rank of the trace
    mesh `mesh` and run `fn` on them once under the op trace and the
    mesh's recording: the rank's figures (module docstring). With
    `whole_batch`, `fn` takes the batch (argument 1) whole, as the
    parallel round does, and reads its own clients' rows of it."""
    blocks = steps.rank_blocks(in_specs, args, mesh)
    arg_pairs = steps.spec_leaves(in_specs, blocks)
    if whole_batch:
        blocks = (blocks[0], args[1]) + tuple(blocks[2:])
    held = sum(_nbytes(x) for _, x in steps.spec_leaves(in_specs, blocks))
    with optrace.OpTrace(budget_s=budget_s, keep_ops=False) as trace, \
            mesh.recording() as log:
        out = fn(*blocks)
    scoped = optrace.analyze(trace)
    memory = _memory(arg_pairs, steps.spec_leaves(out_specs, out),
                     trace.peak, lambda s, x: _nbytes(x))
    live = _live(memory)
    coll = collectives_of(log, mesh)
    return {
        "devices": mesh.size,
        "partition": "rank",
        "rank": mesh.rank,
        "traced_mesh": dict(mesh.shape),
        "memory": memory,
        "held_argument_bytes": held,
        "live_bytes": live,
        "fits": live <= HBM_BYTES,
        "peak_bytes": trace.peak,
        "flops": scoped["flops"],
        "bytes_accessed": scoped["hbm_bytes"],
        "collectives": coll,
        "scoped": {"flops": scoped["flops"],
                   "hbm_bytes": scoped["hbm_bytes"],
                   "collectives": coll,
                   "unknown_trip_loops": scoped["unknown_trip_loops"]},
        "ops": scoped["ops"],
    }


def _trace_shape(multi_pod: bool) -> tuple:
    """The (data, model) shape a rank is traced on: the production mesh
    with its pods on "data", as `launch.mesh.world_mesh` runs a world."""
    sizes = make_production_mesh(multi_pod=multi_pod).shape
    return (sizes.get("pod", 1) * sizes["data"], sizes["model"])


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            verbose: bool = True, tag: str = "baseline", **kw) -> dict:
    budget_s = kw.pop("budget_s", 0.0)
    t0 = time.time()
    mesh = make_trace_mesh(_trace_shape(multi_pod))
    fn, args, in_specs, out_specs, meta = steps.build_step(
        arch, shape_name, mesh, **kw)
    whole = (shapes_mod.SHAPES[shape_name].kind == "train"
             and meta["fl_mode"] == "parallel")
    rec = rank_record(fn, args, in_specs, out_specs, mesh,
                      whole_batch=whole, budget_s=budget_s)
    if multi_pod:
        rec["traced_mesh_note"] = ("the pods on \"data\", as "
                                   "launch.mesh.world_mesh runs a world")
    rec = {"arch": arch, "shape": shape_name, "tag": tag,
           "mesh": mesh_name(multi_pod), "meta": meta,
           "build_s": round(time.time() - t0, 1), **rec}
    if verbose:
        m = rec["memory"]
        c = rec["collectives"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}] build "
              f"{rec['build_s']}s, {rec['ops']} ops")
        print(f"  per device ({rec['partition']} partition): args="
              f"{m['argument_bytes']/2**30:.2f}GiB out="
              f"{m['output_bytes']/2**30:.2f}GiB temp="
              f"{m['temp_bytes']/2**30:.2f}GiB alias="
              f"{m['alias_bytes']/2**30:.2f}GiB (~"
              f"{rec['live_bytes']/2**30:.2f}GiB live; fits "
              f"{rec['fits']})")
        print(f"  rank {rec['rank']} of {rec['traced_mesh']}: flops="
              f"{rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
              f"collectives={c['count']} ({c['total']/2**20:.1f}MiB)")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(shapes_mod.SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="sweep all arch x shape")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--method", default="fedadp", choices=["fedadp", "fedavg"])
    ap.add_argument("--stale", action="store_true",
                    help="sequential engine: one-pass stale angles")
    ap.add_argument("--q-chunk", type=int, default=0,
                    help="query-blocked attention chunk")
    ap.add_argument("--mqa-replicate-kv", action="store_true",
                    help="replicate k/v projections when kv_heads < model axis")
    ap.add_argument("--ssm-unroll", type=int, default=0,
                    help="mamba scan unroll factor")
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="chunked unembed+CE over tokens")
    ap.add_argument("--rs-grads", action="store_true",
                    help="sequential: constrain grads to the FSDP spec")
    ap.add_argument("--ssm-stream-bf16", action="store_true",
                    help="mamba scan xs streams in bf16")
    ap.add_argument("--act-constrain", action="store_true",
                    help="in-model activation sharding constraints")
    ap.add_argument("--moe-combine-bf16", action="store_true",
                    help="MoE combine-scatter accumulates in bf16")
    ap.add_argument("--angle-filter", default="all", choices=["all", "dense_only"])
    ap.add_argument("--tag", default="baseline",
                    help="record tag for perf-iteration bookkeeping")
    ap.add_argument("--budget-s", type=float, default=0.0,
                    help="fail a combo whose traced step runs past this "
                         "many seconds (0: no limit)")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(shapes_mod.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    combos = [(a, s, m) for a in archs for s in shapes for m in meshes]

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("tag", "baseline")))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    records, failures = [], []
    for a, s, m in combos:
        if (a, s, mesh_name(m), args.tag) in done:
            print(f"[skip cached] {a} x {s} x {mesh_name(m)}", flush=True)
            continue
        t0 = time.time()
        try:
            kw = {"budget_s": args.budget_s}
            if shapes_mod.SHAPES[s].kind == "train":
                kw.update(method=args.method, stale=args.stale,
                          angle_filter=args.angle_filter)
                for flag in ("mqa_replicate_kv", "ssm_unroll", "loss_chunk",
                             "rs_grads", "ssm_stream_bf16", "act_constrain",
                             "moe_combine_bf16"):
                    if getattr(args, flag):
                        kw[flag] = getattr(args, flag)
            if args.q_chunk and shapes_mod.SHAPES[s].kind != "decode":
                kw["q_chunk"] = args.q_chunk
            rec = run_one(a, s, multi_pod=m, tag=args.tag, **kw)
            records.append(rec)
            if args.out:  # stream: every record lands immediately
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except Exception as e:  # noqa: BLE001 — sweep must report all failures
            traceback.print_exc()
            failures.append({"arch": a, "shape": s, "multi_pod": m,
                             "error": f"{type(e).__name__}: {e}",
                             "seconds": round(time.time() - t0, 1)})
        sys.stdout.flush()
    print(f"\ndry-run: {len(records)} ok, {len(failures)} failed")
    for f in failures:
        print("  FAIL", json.dumps(f))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
