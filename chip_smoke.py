#!/usr/bin/env python3
"""Drive the PyTorch port's FedAdp round on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

It builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`
with nvcc, checks and times each against its plain torch version, drives
the main path (the synchronous FedAdp round of the flat engine through
`repro_torch.FedServer`, at the full width of the paper's CNN), and
checks the algorithm on the MLR golden task. Each phase prints one JSON
line; any failure raises and the script exits non-zero. It imports
nothing of jax or of the JAX package `repro`.

Phases: device, build, kernels (correctness at the main path's shape and
at edge shapes, then timing), slice (3 CNN rounds with eval; 2
weighted_agg + 1 round_stats launches per round; flat == tree on the
card; one more round under torch.profiler for the device-time
breakdown), algorithm (fedadp reaches 85% on MLR in no more rounds than
fedavg). Then, on lines of their own: the kernel table as one JSON
object, the card's name and power limit as nvidia-smi reports them, and
last `{"ok": true, "device": {...}}`.

Without a CUDA device, or without the repository's `src/` beside it, it
prints no result and exits non-zero. TF32 is off for matmuls and cuDNN
convs, so f32 means f32 everywhere.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks: HBM3 bandwidth and f32 outside the tensor
# cores (both kernels are f32 elementwise-and-reduce work).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TOL = 1e-5
MAIN_K, MAIN_N = 10, 1_663_370  # K clients x the CNN's parameter count
EDGE_KS = (1, 3, 37, 128)
EDGE_NS = (7_850, 16_385, 1_000_003)
REPS = 50


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_us(fn, flush: torch.Tensor) -> float:
    """Median device time of `fn` over REPS launches (CUDA events), after
    warm-up. Before each launch the 256 MB `flush` buffer is summed: a
    read, so it evicts the 50 MB L2 without leaving dirty lines for the
    timed launch to write back, and every launch reads its inputs from
    HBM; it also keeps the GPU busy while the host enqueues the launch."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in
                            zip(starts, ends)])) * 1e3


def bound_us(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---- correctness measures (float64 on the card) ----

def agg_err(y, y_ref, w, x) -> tuple[float, float]:
    """(max |dy|, max |dy_n| / sum_k |w_k x_kn|)."""
    d = (y.double() - y_ref.double()).abs()
    scale = (w.double().abs()[:, None] * x.double().abs()).sum(0)
    return float(d.max()), float((d / scale.clamp_min(1e-30)).max())


def stats_err(got, ref, x, g, mask) -> tuple[float, float]:
    """(max abs error, max normalised error): dots against
    sum_n |x_kn g_n|, squared norms relative to themselves."""
    xd, gd = x.double(), g.double()
    if mask is not None:
        xd, gd = xd * mask.double()[None], gd * mask.double()
    scales = ((xd.abs() * gd.abs()[None]).sum(1), ref[1].double().abs(),
              ref[2].double().abs())
    abs_err = norm_err = 0.0
    for a, b, s in zip(got, ref, scales):
        d = (a.double() - b.double()).abs()
        abs_err = max(abs_err, float(d.max()))
        norm_err = max(norm_err, float((d / s.clamp_min(1e-30)).max()))
    return abs_err, norm_err


def phase_kernels(wa, rs, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(k, n):
        x = torch.randn(k, n, device=dev, generator=gen)
        g = torch.randn(n, device=dev, generator=gen)
        w = torch.rand(k, device=dev, generator=gen)
        mask = (torch.rand(n, device=dev, generator=gen) > 0.25).float()
        return x, g, w, mask

    shapes = [(MAIN_K, MAIN_N)] + [(k, n) for k in EDGE_KS for n in EDGE_NS]
    worst = {"weighted_agg": 0.0, "round_stats": 0.0}
    main_abs = {}
    for k, n in shapes:
        x, g, w, mask = inputs(k, n)
        a, na = agg_err(wa.weighted_agg(w, x), wa.weighted_agg_plain(w, x),
                        w, x)
        worst["weighted_agg"] = max(worst["weighted_agg"], na)
        s_abs = ns = 0.0
        for m in (None, mask):
            sa, nm = stats_err(rs.round_stats(x, g, m),
                               rs.round_stats_plain(x, g, m), x, g, m)
            s_abs, ns = max(s_abs, sa), max(ns, nm)
        worst["round_stats"] = max(worst["round_stats"], ns)
        if (k, n) == (MAIN_K, MAIN_N):
            main_abs = {"weighted_agg": a, "round_stats": s_abs}
        torch.cuda.synchronize()
        emit({"phase": "kernels", "check": [k, n],
              "weighted_agg_err": na, "round_stats_err": ns})
        for name, err in (("weighted_agg", na), ("round_stats", ns)):
            if not err <= TOL:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at K={k}, N={n}: {err}")

    # timing at the main path's shape (the round's inputs: f32, no mask)
    x, g, w, _ = inputs(MAIN_K, MAIN_N)
    flush = torch.zeros(64 << 20, device=dev)
    k, n = MAIN_K, MAIN_N
    rows = {
        "weighted_agg": dict(
            kernel=lambda: wa.weighted_agg(w, x),
            plain=lambda: wa.weighted_agg_plain(w, x),
            library=lambda: w @ x,
            nbytes=4 * (k * n + k + n), flops=2 * k * n,
            replaces="src/repro/kernels/weighted_agg.py:187",
            launches_per_round=2),
        "round_stats": dict(
            kernel=lambda: rs.round_stats(x, g),
            plain=lambda: rs.round_stats_plain(x, g),
            library=None,  # no single torch call returns dots, sqs, ||g||^2
            nbytes=4 * (k * n + n + 2 * k + 1), flops=4 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:157",
            launches_per_round=1),
    }
    table = {}
    for name, r in rows.items():
        us = time_us(r["kernel"], flush)
        plain_us = time_us(r["plain"], flush)
        lib_us = time_us(r["library"], flush) if r["library"] else None
        b_us, b_by = bound_us(r["nbytes"], r["flops"])
        table[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": r["replaces"],
            "max_abs_err": main_abs[name], "max_err": worst[name],
            "tol": TOL,
            "us": us, "ms": us / 1e3, "plain_us": plain_us,
            "plain_ms": plain_us / 1e3, "bound_us": b_us,
            "bound_ms": b_us / 1e3, "bound_by": b_by,
            "library_us": lib_us,
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "launches_per_round": r["launches_per_round"],
            "shape": [k, n], "bytes": r["nbytes"],
            "hbm_share_of_peak": b_us / us,
        }
        emit({"phase": "kernels", "timing": table[name]})
    del flush
    return table


def image_task():
    from repro_torch.data import synthetic

    train, test = synthetic.make_image_task(num_train=12000, num_test=2000)
    spec = [("iid", None)] * 5 + [("xclass", 1)] * 5
    nodes = synthetic.make_federated(train, spec, samples_per_node=600,
                                     seed=1)
    return nodes, test


def phase_slice(wa, rs, dev, nodes, test) -> dict:
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.models import small

    cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                               local_steps=12, method="fedadp", engine="flat",
                               base_lr=0.05)
    server = repro_torch.FedServer("cnn", cfg, nodes, test, batch_size=50,
                                   device=dev)
    n_params = fl_mod.param_count(server.params)
    if n_params != MAIN_N:
        raise AssertionError(f"CNN has {n_params} params, want {MAIN_N}")
    server.step(eval_every=0)  # warm-up: cuDNN plans, allocator
    server.reset()
    torch.cuda.synchronize()

    # the main path, counted: every launch of both kernels in these rounds
    wa.weighted_agg.launches = 0
    rs.round_stats.launches = 0
    round_ms, accs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        m = server.step(eval_every=1)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        for key, v in m.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"metric {key} is not finite: {v}")
        if abs(float(np.sum(m["weights"])) - 1.0) > 1e-6:
            raise AssertionError(f"weights sum to {np.sum(m['weights'])}")
        accs.append(float(m["accuracy"]))
    launches = {"weighted_agg": wa.weighted_agg.launches,
                "round_stats": rs.round_stats.launches}
    if launches != {"weighted_agg": 6, "round_stats": 3}:
        raise AssertionError(f"3 rounds launched {launches}, want 2 + 1 "
                             "per round")

    # flat == tree on the card, from the same state and batches
    from repro_torch.core import driver

    def loss_fn(p, b):
        return small.classification_loss(small.cnn_apply, p, *b)

    gen = torch.Generator(device=dev).manual_seed(123)
    sel = driver.select_clients(gen, 10, 10)
    batches = driver.epoch_batches(gen, server.data, sel)
    sizes = server.data.sizes[sel].float()
    # Each engine trains its clients anew. cuDNN's default backward
    # algorithms sum with atomics, so two trainings differ in the last
    # bits, and on the synthetic images' flat 0/1 plateaus such bits flip
    # max-pool winners; deterministic algorithms make both engines see
    # the same deltas, so the comparison is of the engines alone.
    torch.backends.cudnn.deterministic = True
    outs = {}
    for engine in ("flat", "tree"):
        c = dataclasses.replace(cfg, engine=engine)
        outs[engine] = fl_mod.make_round_fn(loss_fn, c)(
            server.state, batches, sel, sizes)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    (sf, mf), (st, mt) = outs["flat"], outs["tree"]
    pairs = {f"params/{k}": (sf.params[k], st.params[k]) for k in sf.params}
    pairs["angle"] = (sf.angle.smoothed, st.angle.smoothed)
    pairs.update({f"metrics/{k}": (mf[k], mt[k]) for k in mf})
    excess = {}  # max of |flat - tree| - 1e-5 |tree|: <= 1e-5 passes
    for key, (a, b) in pairs.items():
        d = (a.double() - b.double()).abs() - 1e-5 * b.double().abs()
        excess[key] = float(d.max())
    worst = max(excess, key=excess.get)
    if excess[worst] > 1e-5:
        raise AssertionError(f"flat and tree rounds differ: {excess}")

    out = {"phase": "slice", "model": "cnn", "params": n_params,
           "clients": 10, "local_steps": 12, "batch": 50,
           "round_ms": round_ms, "accuracy": accs, "launches": launches,
           "flat_vs_tree_excess_err": excess[worst],
           "flat_vs_tree_worst": worst, "profile": profile_round(server)}
    emit(out)
    return launches


def profile_round(server) -> dict:
    """Where one CNN round's device time goes (torch.profiler): the GPU
    kernels by name, the two ported kernels' share, and the share of the
    round's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.step(eval_every=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    ported = sum(r[0] for r in rows
                 if "agg_kernel" in r[1] or "stats_stage" in r[1])
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_idle_share": 1.0 - busy / wall_us,
            "ported_kernels_us": ported,
            "top": [{"us": u, "kernel": k[:90], "calls": c}
                    for u, k, c in rows[:10]]}


def phase_algorithm(dev, nodes, test) -> dict:
    import repro_torch

    rounds = {}
    for method in ("fedadp", "fedavg"):
        cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                   local_steps=12, method=method,
                                   engine="flat", base_lr=0.05)
        server = repro_torch.FedServer("mlr", cfg, nodes, test,
                                       batch_size=50, device=dev)
        t0 = time.perf_counter()
        hist = server.run(60, target_acc=0.85, eval_every=1)
        rounds[method] = hist.rounds_to_target
        rounds[f"{method}_s"] = time.perf_counter() - t0
    adp = rounds["fedadp"]
    avg = rounds["fedavg"] if rounds["fedavg"] is not None else math.inf
    if adp is None or adp > avg:
        raise AssertionError(f"fedadp {adp} rounds vs fedavg {avg}")
    out = {"phase": "algorithm", "model": "mlr", "target": 0.85,
           "rounds_to_target": rounds}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build
        from repro_torch.kernels import round_stats as rs
        from repro_torch.kernels import weighted_agg as wa
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    t0 = time.perf_counter()
    logs = _build.build(["weighted_agg", "round_stats"])
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    table = phase_kernels(wa, rs, dev)
    nodes, test = image_task()
    launches = phase_slice(wa, rs, dev, nodes, test)
    phase_algorithm(dev, nodes, test)

    for name, row in table.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(table.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
