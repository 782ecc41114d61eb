#!/usr/bin/env python3
"""Time the port's CUDA kernels against another version of their sources,
in one process on one NVIDIA GPU.

    python3 chip_ab.py --alt DIR [--alt DIR ...] [--rounds R]
    python3 chip_ab.py --tree DIR [--rounds R]

from the repository root.

DIR holds another version of `src/repro_torch/kernels/csrc/` (the `.cu`
sources and their `.cuh` headers) with the same C interface, for example
an earlier commit's, unpacked with `git archive`; each DIR given is timed
against the repository's sources in turn. Every kernel variant of
the round (chip_smoke.py's timing rows, at the main path's shape) whose
source DIR holds is timed in both builds, and so are the int4 wire kernels
at group size 8, batched_dot and grad_dot_stats at the CNN's shape, and
flash attention at gemma-2b's prefill shape (chip_smoke.FLASH_MAIN), in
bf16 and in f32 (two kernels of one source). The two builds take turns:
repo, DIR, DIR, repo, R times over, each turn the median of
chip_smoke.REPS launches on a cold L2 (chip_smoke.time_us). It prints one
JSON line per variant with every turn's time and the two medians (for
flash attention also each build's worst error against the plain version,
as a multiple of the reference test's allowance), then the card's name
and power limit.
A source that DIR does not hold is not timed, and a variant whose entry
point DIR's build lacks (a C interface that changed) is reported as
skipped.

--tree DIR times across such a change: DIR holds another checkout of the
whole repository (an earlier commit's, unpacked with `git archive`). Each
turn is a process that builds that tree's kernels and runs its own
chip_smoke.py kernels phase (checks and timings), in the order DIR, repo,
repo, DIR, DIR, repo, ... for 2R turns (R each); it prints one JSON line
per timed variant with every turn's µs and the two medians, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def build_alt(alt: Path, names, build_dir: Path) -> dict:
    """nvcc each named source of `alt` (one process each, all at once)
    with the port's flags; returns {name: ctypes.CDLL}."""
    from repro_torch.kernels import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = (alt / f"{name}.cu").read_bytes()
        src += b"".join(h.read_bytes() for h in sorted(alt.glob("*.cuh")))
        digest = hashlib.sha256(src).hexdigest()[:16]
        out = build_dir / f"lib{name}-alt-{digest}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
               str(alt / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {alt / name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


# one turn of --tree: the kernels phase of the checkout at argv[1]
_TREE_TURN = """
import sys
import torch
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke as cs
from repro_torch import transport as tq
from repro_torch.kernels import _build, round_stats as rs
from repro_torch.kernels import weighted_agg as wa
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(cs.SOURCES)
cs.phase_kernels(wa, rs, tq, torch.device("cuda", 0))
"""


def tree_turns(tree: Path, rounds: int) -> int:
    """--tree: the kernels phase of `tree` and of this checkout, each
    in its own process, in turns."""
    import chip_smoke as cs

    roots = {"tree": str(tree.resolve()), "repo": ROOT}
    order = ("tree", "repo", "repo", "tree") * rounds
    times = {}  # variant -> {"tree": [...], "repo": [...]}
    for which in order[:2 * rounds]:
        out = subprocess.run([sys.executable, "-c", _TREE_TURN,
                              roots[which]], capture_output=True, text=True,
                             cwd=roots[which], check=False)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the kernels phase of {roots[which]} "
                               f"failed (exit {out.returncode})")
        for line in out.stdout.splitlines():
            row = json.loads(line).get("timing") if line.startswith("{") \
                else None
            if row:
                times.setdefault(row["name"], {"tree": [], "repo": []})[
                    which].append(row["us"])
    for name, t in times.items():
        med = {k: float(np.median(v)) for k, v in t.items() if v}
        print(json.dumps({"variant": name, "tree": roots["tree"],
                          "repo_us": t["repo"], "tree_us": t["tree"],
                          "repo_median_us": med.get("repo"),
                          "tree_median_us": med.get("tree"),
                          "repo_over_tree": med["repo"] / med["tree"]
                          if len(med) == 2 else None}), flush=True)
    print(cs.nvidia_smi())
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alt", type=Path, action="append",
                    help="directory of other kernel sources (repeatable)")
    ap.add_argument("--tree", type=Path,
                    help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if (args.alt is None) == (args.tree is None):
        ap.error("give --alt DIR ... or --tree DIR")
    if not torch.cuda.is_available():
        print("chip_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.tree is not None:
        return tree_turns(args.tree, args.rounds)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch import transport as tq
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import grad_dot as gd
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import weighted_agg as wa

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    alts = {}  # DIR -> {source: its build}
    for d in args.alt:
        held = [s for s in cs.SOURCES if (d / f"{s}.cu").is_file()]
        alts[str(d)] = build_alt(d.resolve(), held, _build.BUILD_DIR / "alt")
    names = sorted({s for libs in alts.values() for s in libs})
    _build.build(names)
    repo = {s: _build.load(s) for s in names}

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(cs.MAIN_K, cs.MAIN_N, device=dev, generator=gen)
    g = torch.randn(cs.MAIN_N, device=dev, generator=gen)
    w = torch.rand(cs.MAIN_K, device=dev, generator=gen)
    rows = cs.timing_rows(wa, rs, tq, x, g, w)
    gs = 8
    q4 = tq.quantize(x, "int4", group_size=gs)
    n = cs.MAIN_N
    rows[f"weighted_agg_q4_gs{gs}"] = dict(
        source="weighted_agg_q", kernel=lambda: wa.weighted_agg_q4(
            w, q4.values, q4.scales, n=n, group_size=gs))
    rows[f"round_stats_q4_gs{gs}"] = dict(
        source="round_stats_q", kernel=lambda: rs.round_stats_q4(
            q4.values, q4.scales, g, group_size=gs))
    rows["batched_dot"] = dict(source="batched_dot",
                               kernel=lambda: wa.batched_dot(x, g))
    rows["grad_dot_stats"] = dict(source="grad_dot", shape=[cs.MAIN_N],
                                  kernel=lambda: gd.grad_dot_stats(x[0], g))
    b, t, h, kv, hd = cs.FLASH_MAIN
    q = torch.randn(b, t, h, hd, device=dev, generator=gen).bfloat16()
    k, v = (torch.randn(b, t, kv, hd, device=dev, generator=gen).bfloat16()
            for _ in range(2))
    rows["flash_attention"] = dict(source="flash_attn",
                                   shape=list(cs.FLASH_MAIN),
                                   kernel=lambda: fa.gqa_flash(q, k, v),
                                   want=cs.gqa_plain(fa, q, k, v),
                                   tol=cs.FLASH_TOL["bfloat16"])
    q32, k32, v32 = q.float(), k.float(), v.float()
    rows["flash_attention_f32"] = dict(
        source="flash_attn", shape=list(cs.FLASH_MAIN),
        kernel=lambda: fa.gqa_flash(q32, k32, v32),
        want=cs.gqa_plain(fa, q32, k32, v32), tol=cs.FLASH_TOL["float32"])

    flush = torch.zeros(64 << 20, device=dev)
    for name, r in rows.items():
        src = r["source"]
        for d, alt in alts.items():
            if src not in alt:
                continue
            _build._LIBS[src] = alt[src]
            try:
                r["kernel"]()
            except AttributeError as e:  # DIR's build lacks this entry point
                _build._LIBS[src] = repo[src]
                print(json.dumps({"variant": name, "alt": d,
                                  "skipped": str(e)}))
                continue
            times = {"repo": [], "alt": []}
            for _ in range(args.rounds):
                for which in ("repo", "alt", "alt", "repo"):
                    # the wrappers fetch their library through _build.load
                    _build._LIBS[src] = repo[src] if which == "repo" else \
                        alt[src]
                    times[which].append(cs.time_us(r["kernel"], flush))
            excess = {}
            if "want" in r:  # each build's output against the plain version
                for which, lib in (("repo", repo[src]), ("alt", alt[src])):
                    _build._LIBS[src] = lib
                    excess[f"{which}_max_excess"] = cs.allclose_err(
                        r["kernel"](), r["want"], r["tol"])[1]
            _build._LIBS[src] = repo[src]
            med = {k: float(np.median(v)) for k, v in times.items()}
            print(json.dumps({
                "variant": name, "alt": d, "source": f"{src}.cu",
                "shape": r.get("shape", [cs.MAIN_K, cs.MAIN_N]),
                "repo_us": times["repo"], "alt_us": times["alt"],
                "repo_median_us": med["repo"], "alt_median_us": med["alt"],
                "alt_over_repo": med["alt"] / med["repo"], **excess}),
                flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
