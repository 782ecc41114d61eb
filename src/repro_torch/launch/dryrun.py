"""Dry run: build every (arch x shape x mesh) step on the meta device
and report whether it fits a cluster of H100s. The counterpart of
`repro/launch/dryrun.py`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl

Per combo the step's builder (`launch/steps.py`) makes its arguments on
the meta device at the global shapes, and `fn(*args)` runs once under
`launch.optrace.OpTrace`: nothing is allocated, and every op of the
step (the backward and the recompute included) is recorded. The mesh is
`make_production_mesh`: "32x8" (256 cards) or "2x32x8" (512). A record
holds the reference's keys, with these meanings:

  * memory.argument_bytes / output_bytes — per device, exact: each
    argument's and output's `NamedSpec.shard_shape` bytes;
    memory.alias_bytes — the outputs that are arguments written in place
    (the decode cache);
  * global {flops, bytes_accessed, temp_bytes} — the whole step, measured
    on meta: temp is the trace's peak of live allocated bytes less the
    outputs' (XLA's sense: scratch beside the outputs);
  * flops, bytes_accessed, memory.temp_bytes — the global figures over
    the device count, "partition": "ideal": the dry run traces the whole
    step as one program; one rank's tensor-parallel program on meta is
    ROADMAP Queue 1 item 17;
  * fits — per device, arguments + outputs + temp - alias (the
    reference's live bytes a device) within one card's memory;
  * collectives — {} with the reason: the whole-step trace issues none
    (item 17 traces a rank's);
  * build_s — the builder plus the traced run (the reference's compile_s).

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
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh

NO_COLLECTIVES = ("the step is traced as one program, which issues none; "
                  "one rank's tensor-parallel program on meta with its "
                  "collectives is ROADMAP Queue 1 item 17")


def mesh_name(multi_pod: bool) -> str:
    return "2x32x8" if multi_pod else "32x8"


def _shard_bytes(spec, x: torch.Tensor) -> int:
    n = 1
    for d in spec.shard_shape(tuple(x.shape)):
        n *= d
    return n * x.element_size()


def step_record(fn, args, in_specs, out_specs, mesh, *,
                budget_s: float = 0.0) -> dict:
    """Run `fn(*args)` (meta tensors) once under the op trace; the memory
    and cost figures of the step on `mesh` (module docstring)."""
    arg_pairs = steps.spec_leaves(in_specs, args)
    arg_storages = {id(x.untyped_storage()) for _, x in arg_pairs}
    with optrace.OpTrace(budget_s=budget_s, keep_ops=False) as trace:
        out = fn(*args)
    out_pairs = steps.spec_leaves(out_specs, out)
    aliased = [id(x.untyped_storage()) in arg_storages for _, x in out_pairs]
    new_global = sum(x.numel() * x.element_size()
                     for (_, x), a in zip(out_pairs, aliased) if not a)
    scoped = optrace.analyze(trace)
    temp_global = max(trace.peak - new_global, 0)
    devices = mesh.size
    memory = {
        "argument_bytes": sum(_shard_bytes(s, x) for s, x in arg_pairs),
        "output_bytes": sum(_shard_bytes(s, x) for s, x in out_pairs),
        "temp_bytes": temp_global // devices,
        "alias_bytes": sum(_shard_bytes(s, x)
                           for (s, x), a in zip(out_pairs, aliased) if a),
    }
    live = (memory["argument_bytes"] + memory["output_bytes"]
            + memory["temp_bytes"] - memory["alias_bytes"])
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
        "collectives_note": NO_COLLECTIVES,
        "scoped": {"flops": scoped["flops"] / devices,
                   "hbm_bytes": scoped["hbm_bytes"] / devices,
                   "collectives": {},
                   "unknown_trip_loops": scoped["unknown_trip_loops"]},
        "ops": scoped["ops"],
    }


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            verbose: bool = True, tag: str = "baseline", **kw) -> dict:
    budget_s = kw.pop("budget_s", 0.0)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    fn, args, in_specs, out_specs, meta = steps.build_step(
        arch, shape_name, mesh, **kw)
    rec = step_record(fn, args, in_specs, out_specs, mesh,
                      budget_s=budget_s)
    rec = {"arch": arch, "shape": shape_name, "tag": tag,
           "mesh": mesh_name(multi_pod), "meta": meta,
           "build_s": round(time.time() - t0, 1), **rec}
    if verbose:
        m, g = rec["memory"], rec["global"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}] build "
              f"{rec['build_s']}s, {rec['ops']} ops")
        print(f"  per device (ideal partition): args="
              f"{m['argument_bytes']/2**30:.2f}GiB out="
              f"{m['output_bytes']/2**30:.2f}GiB temp="
              f"{m['temp_bytes']/2**30:.2f}GiB alias="
              f"{m['alias_bytes']/2**30:.2f}GiB (~"
              f"{rec['live_bytes']/2**30:.2f}GiB live; fits "
              f"{rec['fits']})")
        print(f"  global: flops={g['flops']:.3e} bytes={g['bytes_accessed']:.3e}"
              f" temp={g['temp_bytes']/2**30:.2f}GiB")
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
