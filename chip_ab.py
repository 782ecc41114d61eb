#!/usr/bin/env python3
"""Time the port's CUDA kernels against another version of their sources,
in one process on one NVIDIA GPU.

    python3 chip_ab.py --alt DIR [--rounds R]     # from the repository root

DIR holds another version of `src/repro_torch/kernels/csrc/` (the `.cu`
sources and their `.cuh` headers) with the same C interface, for example
an earlier commit's, unpacked with `git archive`. Every kernel variant of
the round (chip_smoke.py's timing rows, at the main path's shape) whose
source DIR holds is timed in both builds, and so are the int4 wire kernels
at group size 8, batched_dot and grad_dot_stats at the CNN's shape, and
flash attention at gemma-2b's prefill shape (chip_smoke.FLASH_MAIN). The two builds take turns: repo, DIR, DIR, repo, R
times over, each turn the median of chip_smoke.REPS launches on a cold L2
(chip_smoke.time_us). It prints one JSON line per variant with every
turn's time and the two medians, then the card's name and power limit.
A source that DIR does not hold is not timed.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alt", required=True, type=Path,
                    help="directory of the other kernel sources")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
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
    names = [s for s in cs.SOURCES if (args.alt / f"{s}.cu").is_file()]
    _build.build(names)
    repo = {s: _build.load(s) for s in names}
    alt = build_alt(args.alt.resolve(), names, _build.BUILD_DIR / "alt")

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
    rows["grad_dot_stats"] = dict(source="grad_dot",
                                  kernel=lambda: gd.grad_dot_stats(x[0], g))
    b, t, h, kv, hd = cs.FLASH_MAIN
    q = torch.randn(b, t, h, hd, device=dev, generator=gen).bfloat16()
    k, v = (torch.randn(b, t, kv, hd, device=dev, generator=gen).bfloat16()
            for _ in range(2))
    rows["flash_attention"] = dict(source="flash_attn",
                                   kernel=lambda: fa.gqa_flash(q, k, v))

    flush = torch.zeros(64 << 20, device=dev)
    for name, r in rows.items():
        src = r["source"]
        if src not in names:
            continue
        _build._LIBS[src] = alt[src]
        try:
            r["kernel"]()
        except AttributeError as e:  # DIR's build lacks this entry point
            _build._LIBS[src] = repo[src]
            print(json.dumps({"variant": name, "skipped": str(e)}))
            continue
        times = {"repo": [], "alt": []}
        for _ in range(args.rounds):
            for which in ("repo", "alt", "alt", "repo"):
                # the wrappers fetch their library through _build.load
                _build._LIBS[src] = repo[src] if which == "repo" else alt[src]
                times[which].append(cs.time_us(r["kernel"], flush))
        _build._LIBS[src] = repo[src]
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(json.dumps({
            "variant": name, "source": f"{src}.cu",
            "shape": [cs.MAIN_K, cs.MAIN_N], "repo_us": times["repo"],
            "alt_us": times["alt"], "repo_median_us": med["repo"],
            "alt_median_us": med["alt"],
            "alt_over_repo": med["alt"] / med["repo"]}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
