#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the repository root

It builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`
with nvcc, checks and times each against its plain torch version, and
drives the port's paths: the synchronous FedAdp round of the flat engine
through `repro_torch.FedServer`, at the full width of the paper's CNN,
on every uplink wire (f32, bf16, int8, int4); the algorithm on the MLR
golden task; dense-LM serving (`launch.serve.generate`: gemma-2b at full
width and depth in bf16, prefill on the flash-attention kernel, then
greedy decode); and `kernels/ops.py` on a real CNN round's deltas. Each
phase prints one JSON line; any failure raises and the script exits
non-zero. It imports nothing of jax or of the JAX package `repro`.

Phases: device, build (all seven sources at once; ptxas's registers and
spills; the HMMA / HGMMA count in the SASS of each head-dim instance of
both flash kernels, bf16 and f32, which must not be 0; the I2F and
LDG.E.128 counts and registers of the wire aggregations and statistics,
which must have no I2F and 16-byte loads), kernels (correctness of the
f32 kernels on f32 and bf16 input and of the int8 / int4 wire kernels at
the main path's shape and at edge shapes, a second launch of each wire
kernel giving the same bits, then timing of every kernel variant, and
the device kernels of one call of each wire kernel, by a profile: one per
aggregation, two per statistics call; batched_dot and
grad_dot_stats the same; flash attention at the reference test's cases,
at every head dim of both kernels, causal and not, at ragged T, through
gqa_flash with grouped KV heads, and at gemma-2b's prefill shape, where
the bf16 and the f32 kernel are timed against SDPA, whose device kernel
is named from a profile), wire (the quantizer on the card equals the quantizer on the CPU
bit for bit), slice (per wire: 3 CNN rounds with eval, with 2
aggregation + 1 statistics launches of the wire's kernels per round, the
quantizer's time, flat == tree on the card, one more round under
torch.profiler; and one int8 run with error feedback), algorithm (fedadp
reaches 85% on MLR in no more rounds than fedavg, per uplink f32, bf16,
int8 and int4; each wire's fedadp rounds over f32's printed), serve
(gemma-2b, B = 4, prompt 1024, 32 greedy steps: 18
flash launches per prefill and none in decode, prefill and decode times,
peak memory, the tensor-core kernel's share of a profiled prefill, where
the f32 kernel must not appear; flash == xla prefill logits on the f32
model, on the f32 kernel, and the two f32 prefill times), ops (tree_vdot_batched and tree_dot_and_norms
on the tree view of a CNN round's (K, N) buffer equal that round's
round_stats; one client's tree_dot_and_norms runs one grad_dot device
kernel a leaf of at most one block, two a larger leaf). Then, on lines
of their own: the kernel table as one JSON object, the card's name and
power limit as nvidia-smi reports them, and last
`{"ok": true, "device": {...}}`.

Without a CUDA device, or without the repository's `src/` beside it, it
prints no result and exits non-zero. TF32 is off for matmuls and cuDNN
convs, so f32 means f32 everywhere (the f32 flash kernel's 3xTF32 holds
f32 accuracy).
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
# H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside the tensor
# cores (the FL kernels are f32 elementwise-and-reduce work) and dense
# bf16 on the tensor cores (where attention's products would run); f32
# products held to f32 accuracy on the tensor cores are 3xTF32, three
# TF32 products (495 TFLOP/s dense) for each f32 one.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
TF32X3_FLOPS_PER_S = 495e12 / 3
TOL = 1e-5
MAIN_K, MAIN_N = 10, 1_663_370  # K clients x the CNN's parameter count
EDGE_KS = (1, 3, 37, 128)
# the odd N give int4 a pad nibble; 13 is shorter than one 16-byte tile of
# the wire aggregations, and 16,385 walks the rows' start through every
# residue mod 16 (int8 and int4)
EDGE_NS = (13, 7_850, 16_385, 1_000_003)
# int4 group sizes checked: 2 and 8 give each byte (or every other byte)
# of a thread its own scale, the others one scale for a thread's columns
GROUP_SIZES = (2, 8, 32, 512, 16_384)
MAIN_GS = 512  # FLConfig's default int4 group size
WIDE_K = 128  # a second timing of each kernel, at 12.8x the main K
REPS = 50
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's clock: the host's head start
WIRES = ("f32", "bf16", "int8", "int4")
SOURCES = ("weighted_agg", "round_stats", "weighted_agg_q", "round_stats_q",
           "flash_attn", "batched_dot", "grad_dot")
# device kernels of the ported sources, by name, for the profile
WIRE_AGG_KERNELS = ("agg_q8_kernel", "agg_q4_kernel")
WIRE_STATS_KERNEL = "stats_q_kernel"
BF16_STATS_KERNEL = "stats_bf16_kernel"  # round_stats on bf16 x
SUM_KERNEL = "stats_sum_kernel"  # the statistics' dependent second launch
GDOT_KERNEL = "gdot_kernel"  # grad_dot_stats
PORTED = ("agg_kernel", *WIRE_AGG_KERNELS, "stats_stage", WIRE_STATS_KERNEL,
          BF16_STATS_KERNEL, SUM_KERNEL, "flash_tf32_kernel",
          "flash_mma_kernel", "bdot_stage", GDOT_KERNEL)
# device kernels of one call of each wire wrapper (the bf16 wire's
# round_stats included): the aggregations fold w into the scales in their
# kernel; the statistics write block partials, then sum them in a second
# (programmatic dependent) launch
WIRE_CALL_KERNELS = {"agg_q8_kernel": 1, "agg_q4_kernel": 1,
                     WIRE_STATS_KERNEL: 2, BF16_STATS_KERNEL: 1,
                     SUM_KERNEL: 3}
# kernel instances whose SASS must hold 16-byte loads (LDG.E.128), by
# source: agg_q8_kernel and agg_q4_kernel<WIDE> (3); stats_q_kernel<INT4,
# WIDE, MASKED> for int8 and both int4 paths, masked and not (6);
# stats_bf16_kernel<MASKED> (2); gdot_kernel<T, SA, SB> for f32 and bf16,
# each input aligned or not (8). The wire kernels must hold no I2F.
SASS_INSTANCES = {"weighted_agg_q": (WIRE_AGG_KERNELS, 3),
                  "round_stats_q": ((WIRE_STATS_KERNEL,), 6),
                  "round_stats": ((BF16_STATS_KERNEL,), 2),
                  "grad_dot": ((GDOT_KERNEL,), 8)}
NO_I2F = ("weighted_agg_q", "round_stats_q")
GDOT_SPAN = 2048  # grad_dot.cu's kSpan: elements a block
# flash attention (BH, T, d, dtype, causal, blk_q, blk_k): the reference
# test's cases, then each kernel (bf16 and f32) at every head dim, causal
# and not, and at T = 96 and 40, not a multiple of its tiles
FLASH_CASES = ((4, 256, 64, "float32", True, 64, 64),
               (2, 256, 128, "float32", False, 128, 64),
               (2, 512, 64, "float32", True, 128, 128),
               (3, 128, 64, "bfloat16", True, 64, 32),
               (2, 256, 64, "bfloat16", False, 64, 64),
               (2, 256, 128, "bfloat16", True, 128, 64),
               (2, 256, 128, "bfloat16", False, 64, 64),
               (2, 256, 256, "bfloat16", True, 128, 128),
               (2, 256, 256, "bfloat16", False, 64, 64),
               (3, 96, 64, "bfloat16", True, 32, 32),
               (2, 96, 128, "bfloat16", False, 32, 32),
               (2, 96, 256, "bfloat16", True, 32, 32),
               (2, 96, 256, "float32", True, 32, 32),
               (2, 256, 64, "float32", False, 64, 64),
               (2, 256, 128, "float32", True, 128, 64),
               (2, 256, 256, "float32", True, 128, 128),
               (2, 256, 256, "float32", False, 64, 64),
               (3, 96, 64, "float32", True, 32, 32),
               (2, 96, 128, "float32", False, 32, 32),
               (2, 96, 256, "float32", False, 32, 32),
               (2, 40, 128, "float32", True, 8, 8),
               (2, 40, 256, "float32", False, 8, 8))
# gqa_flash at (B, T, hd) with these (H, G, dtype), and gemma-2b's
# prefill shape (B, T, H, G, hd)
FLASH_GQA = ((8, 1, "bfloat16"), (4, 2, "bfloat16"), (4, 2, "float32"))
FLASH_GQA_SHAPE = (2, 320, 256)
FLASH_MAIN = (4, 1024, 8, 1, 256)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # the reference test's
SERVE_B, SERVE_T, SERVE_STEPS = 4, 1024, 32
PARITY_B, PARITY_T, PARITY_TOL = 2, 512, 2e-4


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
    HBM. A sleep kernel first holds the device back while the host
    enqueues every launch, so no timed interval waits on the host (a
    wrapper that launches two kernels with Python between them would
    otherwise be timed with the host's delay on a busy host)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in
                            zip(starts, ends)])) * 1e3


def bound_us(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
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


def spread(x: torch.Tensor, block: int) -> torch.Tensor:
    """x with its magnitude changed by orders of magnitude from one block
    of columns to the next, so a kernel that reads the wrong scale column
    fails loudly."""
    cols = torch.arange(x.shape[1], device=x.device) // block % 5
    return x * (10.0 ** cols.float())[None]


def shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of x whose storage starts `offset` bytes past a
    16-byte boundary."""
    per = x.element_size()
    flat = torch.empty(x.numel() + 16 // per, dtype=x.dtype,
                       device=x.device)
    y = flat[offset // per:offset // per + x.numel()].view(x.shape)
    y.copy_(x)
    if y.data_ptr() % 16 != offset:
        raise AssertionError(f"storage at {y.data_ptr() % 16} mod 16, want "
                             f"{offset}")
    return y


def check_wire(name, agg, agg_plain, stats, stats_plain, q, x, w, g, mask,
               **kw):
    """One wire kernel pair against its plain versions: (worst abs error,
    worst normalised error) per wrapper name."""
    akw = dict(kw, n=x.shape[1]) if "group_size" in kw else {}
    y = agg(w, q.values, q.scales, **akw)
    a, na = agg_err(y, agg_plain(w, q.values, q.scales, **akw), w, x)
    if not torch.equal(y, agg(w, q.values, q.scales, **akw)):
        raise AssertionError(f"weighted_agg_{name}: a second launch gave "
                             "other bits")
    s_abs = ns = 0.0
    for m in (None, mask):
        got = stats(q.values, q.scales, g, m, **kw)
        sa, nm = stats_err(got, stats_plain(q.values, q.scales, g, m, **kw),
                           x, g, m)
        s_abs, ns = max(s_abs, sa), max(ns, nm)
        if not all(torch.equal(a, b) for a, b in
                   zip(got, stats(q.values, q.scales, g, m, **kw))):
            raise AssertionError(f"round_stats_{name}: a second launch gave "
                                 "other bits")
    return {f"weighted_agg_{name}": (a, na), f"round_stats_{name}": (s_abs,
                                                                    ns)}


def phase_kernels(wa, rs, tq, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(k, n):
        x = torch.randn(k, n, device=dev, generator=gen)
        g = torch.randn(n, device=dev, generator=gen)
        w = torch.rand(k, device=dev, generator=gen)
        mask = (torch.rand(n, device=dev, generator=gen) > 0.25).float()
        return x, g, w, mask

    shapes = [(MAIN_K, MAIN_N)] + [(k, n) for k in EDGE_KS for n in EDGE_NS]
    worst, main_abs = {}, {}
    for k, n in shapes:
        x, g, w, mask = inputs(k, n)
        errs = {}
        # the f32 kernels on f32 and on bf16 input (the bf16 wire); bf16
        # x also with its storage 4, 8 and 12 bytes past a 16-byte
        # boundary, and a second call of its statistics giving the same
        # bits
        xb = x.to(torch.bfloat16)
        for tag, xins in (("", [x]), ("_bf16", [xb] + [
                shifted(xb, off) for off in (4, 8, 12)])):
            xin, xf = xins[0], xins[0].float()
            errs["weighted_agg" + tag] = agg_err(
                wa.weighted_agg(w, xin, out_dtype=torch.float32),
                wa.weighted_agg_plain(w, xin, torch.float32), w, xf)
            s_abs = ns = 0.0
            for xi in xins:
                for m in (None, mask):
                    got = rs.round_stats(xi, g, m)
                    sa, nm = stats_err(got, rs.round_stats_plain(xi, g, m),
                                       xf, g, m)
                    s_abs, ns = max(s_abs, sa), max(ns, nm)
                    if tag and not all(torch.equal(a, b) for a, b in zip(
                            got, rs.round_stats(xi, g, m))):
                        raise AssertionError("round_stats_bf16: a second "
                                             "launch gave other bits")
            errs["round_stats" + tag] = (s_abs, ns)
            del xins
        # the int8 and int4 wire kernels
        q8 = tq.quantize(spread(x, tq.CHUNK), "int8")
        errs.update(check_wire("q", wa.weighted_agg_q,
                               wa.weighted_agg_q_plain, rs.round_stats_q,
                               rs.round_stats_q_plain, q8, tq.dequantize(q8),
                               w, g, mask))
        for gs in GROUP_SIZES:
            q4 = tq.quantize(spread(x, gs), "int4", group_size=gs)
            for key, v in check_wire(
                    "q4", wa.weighted_agg_q4, wa.weighted_agg_q4_plain,
                    rs.round_stats_q4, rs.round_stats_q4_plain, q4,
                    tq.dequantize(q4), w, g, mask, group_size=gs).items():
                old = errs.get(key, (0.0, 0.0))
                errs[key] = (max(old[0], v[0]), max(old[1], v[1]))
        torch.cuda.synchronize()
        emit({"phase": "kernels", "check": [k, n],
              "norm_err": {key: v[1] for key, v in errs.items()}})
        for key, (a, e) in errs.items():
            worst[key] = max(worst.get(key, 0.0), e)
            if (k, n) == (MAIN_K, MAIN_N):
                main_abs[key] = a
            if not e <= TOL:
                raise AssertionError(f"{key} disagrees with its plain "
                                     f"version at K={k}, N={n}: {e}")

    # timing at the main path's shape and dtypes (no mask, as the round),
    # and of the kernels alone at WIDE_K clients: ~13x the bytes, so a
    # kernel whose time grows less than that is held back by a fixed cost
    # (launch, the one wave of blocks), not by the memory rate
    flush = torch.zeros(64 << 20, device=dev)
    rows = timing_rows(wa, rs, tq, *inputs(MAIN_K, MAIN_N)[:3])
    wide = timing_rows(wa, rs, tq, *inputs(WIDE_K, MAIN_N)[:3])
    table = {}
    for name, r in rows.items():
        us = time_us(r["kernel"], flush)
        plain_us = time_us(r["plain"], flush)
        lib_us = time_us(r["library"], flush) if r["library"] else None
        wide_us = time_us(wide[name]["kernel"], flush)
        b_us, b_by = bound_us(r["nbytes"], r["flops"])
        table[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{r['source']}.cu",
            "replaces": r["replaces"], "wire": r["wire"],
            "max_abs_err": main_abs[name], "max_err": worst[name],
            "tol": TOL,
            "us": us, "ms": us / 1e3, "plain_us": plain_us,
            "plain_ms": plain_us / 1e3, "bound_us": b_us,
            "bound_ms": b_us / 1e3, "bound_by": b_by,
            "library_us": lib_us,
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "shape": [MAIN_K, MAIN_N], "bytes": r["nbytes"],
            "hbm_share_of_peak": b_us / us,
            "wide_k": WIDE_K, "wide_us": wide_us,
            "wide_hbm_share_of_peak": bound_us(wide[name]["nbytes"],
                                               wide[name]["flops"])[0]
            / wide_us,
        }
        emit({"phase": "kernels", "timing": table[name]})
    del flush
    # one call of each wire wrapper: exactly the device kernels of
    # WIRE_CALL_KERNELS, and no PyTorch op beside them
    wire = ("weighted_agg_q", "weighted_agg_q4", "round_stats_q",
            "round_stats_q4", "round_stats_bf16")
    prof = profile_whole(lambda: [rows[name]["kernel"]() for name in wire])
    ran = [(t["kernel"], t["calls"]) for t in prof["top"]]
    calls = {key: sum(c for k, c in ran if key in k)
             for key in WIRE_CALL_KERNELS}
    emit({"phase": "kernels", "device_kernels_of_one_call_each": {
        "wrappers": wire, "kernels": ran}})
    if calls != WIRE_CALL_KERNELS or prof["device_events_distinct"] != sum(
            WIRE_CALL_KERNELS.values()):
        raise AssertionError(f"one call each of {wire} ran {ran}, want "
                             f"{WIRE_CALL_KERNELS}")
    return table


def timing_rows(wa, rs, tq, x, g, w) -> dict:
    """Every kernel variant of the round at x's shape: the kernel, its
    plain version, a PyTorch call of the same function where one exists,
    and the bytes and flops of its bound."""
    xb = x.to(torch.bfloat16)
    q8 = tq.quantize(x, "int8")
    q4 = tq.quantize(x, "int4", group_size=MAIN_GS)
    k, n = x.shape
    c8, c4, nb = q8.scales.shape[1], q4.scales.shape[1], q4.values.shape[1]
    stats_out = 4 * (2 * k + 1)
    f32 = torch.float32
    return {
        "weighted_agg": dict(
            kernel=lambda: wa.weighted_agg(w, x),
            plain=lambda: wa.weighted_agg_plain(w, x),
            library=lambda: w @ x,
            nbytes=4 * (k * n + k + n), flops=2 * k * n,
            replaces="src/repro/kernels/weighted_agg.py:187",
            source="weighted_agg", wire="f32"),
        "weighted_agg_bf16": dict(
            kernel=lambda: wa.weighted_agg(w, xb, out_dtype=f32),
            plain=lambda: wa.weighted_agg_plain(w, xb, f32),
            # no single call: matmul wants one dtype, and a bf16 matmul
            # returns a bf16 sum
            library=None,
            nbytes=2 * k * n + 4 * (k + n), flops=2 * k * n,
            replaces="src/repro/kernels/weighted_agg.py:187",
            source="weighted_agg", wire="bf16"),
        "round_stats": dict(
            kernel=lambda: rs.round_stats(x, g),
            plain=lambda: rs.round_stats_plain(x, g),
            library=None,  # no single torch call returns dots, sqs, ||g||^2
            nbytes=4 * (k * n + n) + stats_out, flops=4 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:157",
            source="round_stats", wire="f32"),
        "round_stats_bf16": dict(
            kernel=lambda: rs.round_stats(xb, g),
            plain=lambda: rs.round_stats_plain(xb, g),
            library=None,
            nbytes=2 * k * n + 4 * n + stats_out, flops=4 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:157",
            source="round_stats", wire="bf16"),
        # the wire kernels: no PyTorch call dequantizes and reduces in one
        "weighted_agg_q": dict(
            kernel=lambda: wa.weighted_agg_q(w, q8.values, q8.scales),
            plain=lambda: wa.weighted_agg_q_plain(w, q8.values, q8.scales),
            library=None,
            nbytes=k * n + 4 * (k * c8 + k + n), flops=2 * k * n + k * c8,
            replaces="src/repro/kernels/weighted_agg.py:236",
            source="weighted_agg_q", wire="int8"),
        "weighted_agg_q4": dict(
            kernel=lambda: wa.weighted_agg_q4(w, q4.values, q4.scales, n=n,
                                              group_size=MAIN_GS),
            plain=lambda: wa.weighted_agg_q4_plain(
                w, q4.values, q4.scales, n=n, group_size=MAIN_GS),
            library=None,
            nbytes=k * nb + 4 * (k * c4 + k + n), flops=2 * k * n + k * c4,
            replaces="src/repro/kernels/weighted_agg.py:298",
            source="weighted_agg_q", wire="int4"),
        "round_stats_q": dict(
            kernel=lambda: rs.round_stats_q(q8.values, q8.scales, g),
            plain=lambda: rs.round_stats_q_plain(q8.values, q8.scales, g),
            library=None,
            nbytes=k * n + 4 * (k * c8 + n) + stats_out,
            flops=5 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:402",
            source="round_stats_q", wire="int8"),
        "round_stats_q4": dict(
            kernel=lambda: rs.round_stats_q4(q4.values, q4.scales, g,
                                             group_size=MAIN_GS),
            plain=lambda: rs.round_stats_q4_plain(q4.values, q4.scales, g,
                                                  group_size=MAIN_GS),
            library=None,
            nbytes=k * nb + 4 * (k * c4 + n) + stats_out,
            flops=5 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:293",
            source="round_stats_q", wire="int4"),
    }


def phase_wire(tq, dev) -> dict:
    """The quantizer on the card against the quantizer on the CPU, bit for
    bit, at the main path's shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = spread(torch.randn(MAIN_K, MAIN_N, device=dev, generator=gen),
               MAIN_GS) * 1e-3
    x[-1, :tq.CHUNK + 5] = 0.0  # all-zero chunks and groups
    x_cpu = x.cpu()
    out = {"phase": "wire", "shape": [MAIN_K, MAIN_N]}
    for transport in ("bf16", "int8", "int4"):
        a = tq.quantize(x, transport, group_size=MAIN_GS)
        b = tq.quantize(x_cpu, transport, group_size=MAIN_GS)
        same = torch.equal(a.values.cpu().view(torch.uint8),
                           b.values.view(torch.uint8)) and (
            b.scales is None or torch.equal(a.scales.cpu().view(torch.int32),
                                            b.scales.view(torch.int32)))
        if not same:
            raise AssertionError(f"{transport}: the card's wire differs "
                                 "from the CPU's")
        out[transport] = {"values_bytes": a.values.numel()
                          * a.values.element_size(), "bit_equal": True}
    emit(out)
    return out


def image_task():
    from repro_torch.data import synthetic

    train, test = synthetic.make_image_task(num_train=12000, num_test=2000)
    spec = [("iid", None)] * 5 + [("xclass", 1)] * 5
    nodes = synthetic.make_federated(train, spec, samples_per_node=600,
                                     seed=1)
    return nodes, test


def slice_config(transport: str, **kw):
    import repro_torch

    return repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                local_steps=12, method="fedadp",
                                engine="flat", base_lr=0.05,
                                transport=transport, **kw)


def counters(wa, rs) -> dict:
    return {"weighted_agg": wa.weighted_agg, "round_stats": rs.round_stats,
            "weighted_agg_q": wa.weighted_agg_q,
            "weighted_agg_q4": wa.weighted_agg_q4,
            "round_stats_q": rs.round_stats_q,
            "round_stats_q4": rs.round_stats_q4}


def expected_launches(transport: str, rounds: int) -> dict:
    suffix = {"int8": "_q", "int4": "_q4"}.get(transport, "")
    want = {name: 0 for name in ("weighted_agg", "round_stats",
                                 "weighted_agg_q", "weighted_agg_q4",
                                 "round_stats_q", "round_stats_q4")}
    want["weighted_agg" + suffix] = 2 * rounds
    want["round_stats" + suffix] = rounds
    return want


def phase_slice(wa, rs, tq, dev, nodes, test, transport) -> dict:
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.models import small

    cfg = slice_config(transport)
    server = repro_torch.FedServer("cnn", cfg, nodes, test, batch_size=50,
                                   device=dev)
    n_params = fl_mod.param_count(server.params)
    if n_params != MAIN_N:
        raise AssertionError(f"CNN has {n_params} params, want {MAIN_N}")
    server.step(eval_every=0)  # warm-up: cuDNN plans, allocator
    server.reset()
    torch.cuda.synchronize()

    # the main path, counted: every launch of every wrapper in these rounds
    wrappers = counters(wa, rs)
    for fn in wrappers.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if launches != expected_launches(transport, 3):
        raise AssertionError(f"{transport}: 3 rounds launched {launches}, "
                             "want 2 aggregations + 1 statistics per round "
                             "of the wire's kernels")

    # the quantizer's share of a round: one quantize of the round's (K, N)
    # f32 buffer (and the dequantize that error feedback and the tree
    # engine run), timed alone with CUDA events
    quant = {}
    if transport != "f32":
        buf = torch.randn(MAIN_K, MAIN_N, device=dev) * 1e-2
        flush = torch.zeros(64 << 20, device=dev)
        wire = tq.quantize(buf, transport)
        quant = {"quantize_us": time_us(lambda: tq.quantize(buf, transport),
                                        flush),
                 "dequantize_us": time_us(lambda: tq.dequantize(wire),
                                          flush)}
        del buf, flush, wire

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
        raise AssertionError(f"{transport}: flat and tree rounds differ: "
                             f"{excess}")

    out = {"phase": "slice", "model": "cnn", "transport": transport,
           "params": n_params, "clients": 10, "local_steps": 12,
           "batch": 50, "round_ms": round_ms, "accuracy": accs,
           "launches": launches, **quant,
           "flat_vs_tree_excess_err": excess[worst],
           "flat_vs_tree_worst": worst, "profile": profile_round(server)}
    emit(out)
    return launches


def phase_error_feedback(nodes, test, dev) -> dict:
    """int8 with and without error feedback from the same seed: the same
    round 1 (the residual starts at zero), different rounds from 2 on;
    the carried residual is finite and nonzero. Deterministic cuDNN, so
    the two runs train the same deltas until the residual enters."""
    import repro_torch

    torch.backends.cudnn.deterministic = True
    servers = {ef: repro_torch.FedServer(
        "cnn", slice_config("int8", error_feedback=ef), nodes, test,
        batch_size=50, device=dev) for ef in (False, True)}
    gaps = []
    for _ in range(3):
        for s in servers.values():
            s.step(eval_every=0)
        gaps.append(max(float((servers[True].params[k]
                               - servers[False].params[k]).abs().max())
                        for k in servers[True].params))
    torch.backends.cudnn.deterministic = False
    ef = servers[True].state.ef
    ef_abs = float(ef.abs().max())
    if servers[False].state.ef is not None:
        raise AssertionError("a config without error_feedback carries ef")
    if not (math.isfinite(ef_abs) and ef_abs > 0
            and bool(torch.isfinite(ef).all())):
        raise AssertionError(f"state.ef is not finite and nonzero: {ef_abs}")
    if not (gaps[0] <= 1e-6 and min(gaps[1:]) > 10 * max(gaps[0], 1e-7)):
        raise AssertionError(f"EF trajectory gaps per round {gaps}: want "
                             "the same round 1 and a gap from round 2 on")
    out = {"phase": "error_feedback", "transport": "int8",
           "param_gap_per_round": gaps, "ef_abs_max": ef_abs}
    emit(out)
    return out


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def overlaps(events, top: int = 8) -> list:
    """The pairs of device events that overlap in time most: each event
    against the one that, of those started before it, ends last."""
    pairs, last = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if last is not None and e.time_range.start < last.time_range.end:
            pairs.append((min(e.time_range.end, last.time_range.end)
                          - e.time_range.start, last, e))
        if last is None or e.time_range.end > last.time_range.end:
            last = e
    pairs.sort(key=lambda p: -p[0])
    return [{"us": us, "first": a.name[:60], "first_stream": stream_of(a),
             "second": b.name[:60], "second_stream": stream_of(b)}
            for us, a, b in pairs[:top]]


def stream_of(event) -> str:
    # a device event's resource id is the CUDA stream it ran on
    return str(getattr(event, "device_resource_id", None))


def profile_round(server) -> dict:
    """Where one CNN round's device time goes (`profile_device`)."""
    return profile_device(lambda: server.step(eval_every=0))


def device_kernels(fn, top: int = 50) -> list:
    """[(kernel name, calls)] of one call of `fn`, from the fullest of a
    few traces (`profile_whole`). Each trace begins with a short sleep
    kernel of its own, left out of the list: a trace on the H100 now and
    then loses its first device event."""
    def run():
        torch.cuda._sleep(1000)
        fn()

    return [(t["kernel"], t["calls"])
            for t in profile_whole(run, top=top)["top"]
            if "spin_kernel" not in t["kernel"]]


def profile_whole(fn, traces: int = 3, top: int = 12) -> dict:
    """`profile_device` of a call without side effects, `traces` times,
    keeping the trace with the most device events. A trace on the H100
    now and then loses device events, the first kernel or all of them,
    and never gains one: a check that counts kernels reads the fullest
    of a few traces, which is whole unless every one of them lost."""
    return max((profile_device(fn, top) for _ in range(traces)),
               key=lambda p: p["device_events_distinct"])


def profile_device(fn, top: int = 12) -> dict:
    """Where one call of `fn`'s device time goes (torch.profiler): the
    GPU kernels by name, the ported kernels' share, and how busy the
    device was. Busy time is given two ways, the sum of the device
    events' times and the union of their intervals; they differ only
    where events overlap in time. Each is given per stream too, with the
    events that overlap most, so that an overlap can be told apart: work
    on two streams at once, or events of one stream. Events that only
    mark a user annotation on the device's timeline are counted apart.
    `top`: the kernels listed, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # no earlier work in the trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    events = [e for e in device
              if not getattr(e, "is_user_annotation", False)]

    def span(e):
        return e.time_range.start, e.time_range.end

    busy_sum = sum(hi - lo for lo, hi in map(span, events))
    busy_union = union_us(map(span, events))
    streams = {}
    for e in events:
        streams.setdefault(stream_of(e), []).append(e)
    ported = sum(r[0] for r in rows if any(p in r[1] for p in PORTED))
    return {"wall_us": wall_us,
            "device_busy_sum_us": busy_sum,
            "device_busy_union_us": busy_union,
            "device_idle_share_sum": 1.0 - busy_sum / wall_us,
            "device_idle_share_union": 1.0 - busy_union / wall_us,
            "kernel_time_sum_us": sum(r[0] for r in rows),
            "device_events": len(events),
            "device_events_distinct": len({(e.name, *span(e))
                                           for e in events}),
            "annotation_events": len(device) - len(events),
            "streams": {s: {"events": len(es),
                            "sum_us": sum(hi - lo for lo, hi in map(span, es)),
                            "union_us": union_us(map(span, es))}
                        for s, es in streams.items()},
            "overlaps": overlaps(events),
            "ported_kernels_us": ported,
            "ported_by_kernel_us": {
                p: sum(r[0] for r in rows if p in r[1]) for p in PORTED
                if any(p in r[1] for r in rows)},
            "top": [{"us": u, "kernel": k[:90], "calls": c}
                    for u, k, c in rows[:top]]}


def phase_algorithm(dev, nodes, test) -> dict:
    import repro_torch

    rounds = {}
    for transport in WIRES:
        for method in ("fedadp", "fedavg"):
            cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                       local_steps=12, method=method,
                                       engine="flat", base_lr=0.05,
                                       transport=transport)
            server = repro_torch.FedServer("mlr", cfg, nodes, test,
                                           batch_size=50, device=dev)
            t0 = time.perf_counter()
            hist = server.run(60, target_acc=0.85, eval_every=1)
            rounds[f"{transport}/{method}"] = hist.rounds_to_target
            rounds[f"{transport}/{method}_s"] = time.perf_counter() - t0
        adp = rounds[f"{transport}/fedadp"]
        avg = rounds[f"{transport}/fedavg"]
        avg = math.inf if avg is None else avg
        if adp is None or adp > avg:
            raise AssertionError(f"uplink {transport}: fedadp {adp} rounds "
                                 f"vs fedavg {avg}")
    # each wire's fedadp rounds over f32's, printed and not held: one seed
    # moves a threshold crossing by whole rounds in either package
    ratio = {t: rounds[f"{t}/fedadp"] / rounds["f32/fedadp"]
             for t in WIRES[1:]}
    out = {"phase": "algorithm", "model": "mlr", "target": 0.85,
           "rounds_to_target": rounds, "fedadp_rounds_over_f32": ratio}
    emit(out)
    return out


# ---- the dense-LM serving path and kernels/ops.py ----

def timing_entry(name, source, replaces, kernel, plain, library, nbytes,
                 flops, flush, max_abs_err, tol, shape,
                 flops_per_s=F32_FLOPS_PER_S) -> dict:
    """One kernel's row of the table: its time, its plain version's, a
    library call's (None where no single call computes the function),
    and its bound, all at `shape`. `source`: the file of csrc/ that holds
    the kernel."""
    us = time_us(kernel, flush)
    plain_us = time_us(plain, flush)
    lib_us = time_us(library, flush) if library else None
    b_us, b_by = bound_us(nbytes, flops, flops_per_s)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": max_abs_err, "tol": tol,
            "us": us, "ms": us / 1e3, "plain_us": plain_us,
            "plain_ms": plain_us / 1e3, "bound_us": b_us,
            "bound_ms": b_us / 1e3, "bound_by": b_by, "library_us": lib_us,
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "shape": list(shape), "bytes": nbytes, "flops": flops}


def sums_err(got, ref, terms) -> tuple[float, float]:
    """(max abs error, max error / sum of |terms|) over paired sums."""
    abs_err = norm_err = 0.0
    for a, b, t in zip(got, ref, terms):
        d = (a.double() - b.double()).abs()
        abs_err = max(abs_err, float(d.max()))
        norm_err = max(norm_err, float((d / t.clamp_min(1e-30)).max()))
    return abs_err, norm_err


def dot_terms(a, b) -> list:
    """The |terms| of (<a,b>, ||a||^2, ||b||^2), in float64."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return [(a * b).abs().sum(), (a * a).sum(), (b * b).sum()]


def phase_ops_kernels(wa, gd, dev) -> dict:
    """batched_dot and grad_dot_stats against their plain versions at
    the edge shapes and the CNN's (K, N), f32 and bf16 input, then timed
    at the CNN's shape in f32 (batched_dot: K = 10 rows against g;
    grad_dot_stats: one client's delta against g)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst, main_abs = {}, {}
    for k, n in [(MAIN_K, MAIN_N)] + [(k, n) for k in EDGE_KS
                                      for n in EDGE_NS]:
        x = torch.randn(k, n, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        g = torch.randn(n, device=dev, generator=gen)
        errs = {}
        for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
            xi, yi, gi = x.to(dt), y.to(dt), g.to(dt)
            terms = [(xi.double().abs() * gi.double().abs()[None]).sum(1)]
            errs["batched_dot" + tag] = sums_err(
                [wa.batched_dot(xi, gi)], [wa.batched_dot_plain(xi, gi)],
                terms)
            errs["grad_dot_stats" + tag] = sums_err(
                gd.grad_dot_stats(xi, yi), gd.grad_dot_stats_plain(xi, yi),
                dot_terms(xi, yi))
        torch.cuda.synchronize()
        emit({"phase": "kernels", "check": [k, n],
              "norm_err": {key: v[1] for key, v in errs.items()}})
        for key, (a, e) in errs.items():
            worst[key] = max(worst.get(key, 0.0), e)
            if (k, n) == (MAIN_K, MAIN_N):
                main_abs[key] = a
            if not e <= TOL:
                raise AssertionError(f"{key} disagrees with its plain "
                                     f"version at K={k}, N={n}: {e}")
        del x, y, g
    emit({"phase": "kernels", "ops_worst_norm_err": worst})

    # grad_dot_stats runs one device kernel on one block and a second
    # (the dependent sum) above
    a = torch.randn(GDOT_SPAN + 1, device=dev, generator=gen)
    for n, want in ((GDOT_SPAN, {GDOT_KERNEL: 1, SUM_KERNEL: 0}),
                    (GDOT_SPAN + 1, {GDOT_KERNEL: 1, SUM_KERNEL: 1})):
        ran = device_kernels(lambda: gd.grad_dot_stats(a[:n], a[:n]))
        got = {key: sum(c for k, c in ran if key in k) for key in want}
        emit({"phase": "kernels", "grad_dot_stats_device_kernels": {
            "n": n, "kernels": ran}})
        if got != want or sum(c for _, c in ran) != sum(want.values()):
            raise AssertionError(f"grad_dot_stats at n = {n} ran {ran}, "
                                 f"want {want}")

    flush = torch.zeros(64 << 20, device=dev)
    x = torch.randn(MAIN_K, MAIN_N, device=dev, generator=gen)
    g = torch.randn(MAIN_N, device=dev, generator=gen)
    k, n = x.shape
    # client 1's row of the round's buffer starts 8 bytes past a 16-byte
    # boundary; g here too
    g8 = shifted(g, 8)
    table = {
        "batched_dot": timing_entry(
            "batched_dot", "batched_dot.cu",
            "src/repro/kernels/weighted_agg.py:347",
            lambda: wa.batched_dot(x, g), lambda: wa.batched_dot_plain(x, g),
            lambda: x @ g, 4 * (k * n + n + k), 2 * k * n, flush,
            main_abs["batched_dot"], TOL, (k, n)),
        # no single torch call returns all three sums
        "grad_dot_stats": timing_entry(
            "grad_dot_stats", "grad_dot.cu",
            "src/repro/kernels/grad_dot.py:61",
            lambda: gd.grad_dot_stats(x[0], g),
            lambda: gd.grad_dot_stats_plain(x[0], g), None, 4 * 2 * n + 12,
            6 * n, flush, main_abs["grad_dot_stats"], TOL, (n,)),
        "grad_dot_stats_off8": timing_entry(
            "grad_dot_stats_off8", "grad_dot.cu",
            "src/repro/kernels/grad_dot.py:61",
            lambda: gd.grad_dot_stats(x[1], g8),
            lambda: gd.grad_dot_stats_plain(x[1], g8), None,
            4 * 2 * n + 12, 6 * n, flush,
            sums_err(gd.grad_dot_stats(x[1], g8),
                     gd.grad_dot_stats_plain(x[1], g8),
                     dot_terms(x[1], g8))[0], TOL, (n,)),
    }
    table["grad_dot_stats_off8"]["offsets_mod_16"] = [
        x[1].data_ptr() % 16, g8.data_ptr() % 16]
    for row in table.values():
        row["max_err"] = worst[row["name"].removesuffix("_off8")]
        emit({"phase": "kernels", "timing": row})
    return table


def gqa_plain(fa, q, k, v):
    """gqa_flash's plain version on (B, T, H, hd) / (B, T, G, hd)."""
    b, t, h, hd = q.shape
    rep = h // k.shape[2]

    def flat(z):
        return z.movedim(2, 1).reshape(-1, t, hd)

    o = fa.flash_attention_plain(flat(q), flat(k.repeat_interleave(rep, 2)),
                                 flat(v.repeat_interleave(rep, 2)), True)
    return o.reshape(b, h, t, hd).movedim(1, 2)


def allclose_err(got, want, tol) -> tuple[float, float]:
    """(max |d|, max |d| / (tol + tol |want|)): <= 1 passes, the
    reference test's assert_allclose(atol=tol, rtol=tol)."""
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d / (tol + tol * want.double().abs()))
                                 .max())


def phase_flash_kernel(fa, dev) -> dict:
    """flash_attention against its plain version at FLASH_CASES, gqa_flash
    at FLASH_GQA and at gemma-2b's prefill shape (bf16 and f32); then both
    kernels timed at gemma's shape: bf16 (bf16 wgmma) and f32 (3xTF32
    mma.sync), each beside SDPA in its dtype (KV repeated to H), with the
    device kernel SDPA ran in one profiled call, and the plain version.
    The f32 row's bound is the 3xTF32 one on the tensor cores; the bound
    on the f32 CUDA cores is given beside it."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4)
    checks = {}
    for bh, t, d, dtype, causal, bq, bk in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen).to(dt)
                   for _ in range(3))
        got = fa.flash_attention(q, k, v, causal, bq, bk)
        want = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        checks[f"{bh}x{t}x{d}/{dtype}/causal={causal}/{bq}x{bk}"] = \
            allclose_err(got, want, FLASH_TOL[dtype])
    b, t, hd = FLASH_GQA_SHAPE
    for h, g, dtype in FLASH_GQA:
        dt = getattr(torch, dtype)
        q = torch.randn(b, t, h, hd, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(b, t, g, hd, device=dev, generator=gen).to(dt)
                for _ in range(2))
        checks[f"gqa {b}x{t}x{h}/{g}x{hd}/{dtype}/causal"] = allclose_err(
            fa.gqa_flash(q, k, v, blk_q=64, blk_k=64),
            gqa_plain(fa, q, k, v), FLASH_TOL[dtype])
    b, t, h, g, hd = FLASH_MAIN
    main = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = torch.randn(b, t, h, hd, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(b, t, g, hd, device=dev, generator=gen).to(dt)
                for _ in range(2))
        err = allclose_err(fa.gqa_flash(q, k, v), gqa_plain(fa, q, k, v),
                           FLASH_TOL[dtype])
        checks[f"gemma-2b {b}x{t}x{h}/{g}x{hd}/{dtype}/causal"] = err
        main[dtype] = (q, k, v, err[0])
    worst = {dtype: max(e[1] for key, e in checks.items()
                        if f"/{dtype}/" in key) for dtype in FLASH_TOL}
    emit({"phase": "kernels", "flash_checks": checks,
          "flash_worst_excess": worst})
    bad = {key: e for key, e in checks.items() if not e[1] <= 1.0}
    if bad:
        raise AssertionError(f"flash attention disagrees with its plain "
                             f"version: {bad}")

    flush = torch.zeros(64 << 20, device=dev)
    flops = b * h * 2 * t * t * hd  # causal: half of 4 T^2 d per head
    table = {}
    for name, dtype, source, rate in (
            ("flash_attention", "bfloat16", "flash_mma.cuh",
             BF16_TC_FLOPS_PER_S),
            ("flash_attention_f32", "float32", "flash_attn.cu",
             TF32X3_FLOPS_PER_S)):
        q, k, v, err = main[dtype]
        qh = q.movedim(2, 1).contiguous()  # (B, H, T, hd), SDPA's layout
        kh, vh = (z.repeat_interleave(h // g, 2).movedim(2, 1).contiguous()
                  for z in (k, v))
        nbytes = q.element_size() * (2 * b * t * h * hd + 2 * b * t * g * hd)
        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        row = timing_entry(
            name, source, "src/repro/kernels/flash_attn.py:84",
            lambda: fa.gqa_flash(q, k, v), lambda: gqa_plain(fa, q, k, v),
            sdpa, nbytes, flops, flush, err, FLASH_TOL[dtype], FLASH_MAIN,
            flops_per_s=rate)
        row["dtype"], row["device_kernel"] = dtype, fa.KERNELS[q.dtype]
        # which kernel the library call ran: the longest one of a profile
        row["library_device_kernel"] = profile_whole(sdpa)["top"][0]
        row["bound_f32_cores_us"] = bound_us(nbytes, flops)[0]
        row["bound_tf32x3_tensor_cores_us"] = bound_us(
            nbytes, flops, TF32X3_FLOPS_PER_S)[0]
        row["max_err"] = worst[dtype]
        emit({"phase": "kernels", "timing": row})
        table[name] = row
    return table


def sass_counts(lib, kernel: str, opcodes) -> dict:
    """How many SASS instructions of each of `opcodes` (matched as
    substrings: "I2F" also counts I2FP) every instance of `kernel` in the
    built library `lib` holds, by cuobjdump (from nvcc's directory):
    {mangled name: {opcode: count}}."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if kernel in fn:
                counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn in counts:
            for op in opcodes:
                counts[fn][op] += op in line
    return counts


def ptxas_registers(log: str) -> dict:
    """{mangled kernel name: registers} from an nvcc -Xptxas=-v log."""
    regs, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = int(line.split("Used", 1)[1].split()[0])
    return regs


def kernel_registers(source: str, logs: dict) -> dict:
    """{mangled kernel name: registers} of csrc/<source>.cu's build: from
    this process's nvcc log, else (a library built earlier) from
    cuobjdump -res-usage."""
    if source in logs:
        return ptxas_registers(logs[source])
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage",
                          str(_build.library_path(source))],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    regs, fn = {}, None
    for line in out.splitlines():
        if "Function" in line:
            fn = line.split("Function", 1)[1].strip().rstrip(":")
        elif fn and "REG:" in line:
            regs[fn] = int(line.split("REG:", 1)[1].split()[0])
    return regs


def bf16_stats_wave(rs, sass: dict) -> dict:
    """Whether the unmasked bf16 statistics kernel's grid at the main
    shape fits one wave: the blocks of 64 threads an SM holds at its
    registers (allocated 256 a warp), against the grid's blocks."""
    regs = [c["registers"] for fn, c in sass.items()
            if BF16_STATS_KERNEL in fn and "ILb0" in fn]
    if len(regs) != 1 or regs[0] is None:
        raise AssertionError(f"no registers of the unmasked "
                             f"{BF16_STATS_KERNEL}: {sass}")
    per_warp = -(-regs[0] * 32 // 256) * 256
    per_sm = min(32, 65536 // (2 * per_warp))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = rs.bf16_stats_blocks(MAIN_K, MAIN_N)
    return {"registers": regs[0], "blocks_per_sm": per_sm, "sms": sms,
            "blocks": blocks, "one_wave": per_sm * sms >= blocks}


def phase_serve(fa, dev) -> dict:
    """The dense-LM serving path at full width and depth: gemma-2b in
    bf16 with flash attention, random weights from a seed, through
    `launch.serve.generate` (B = 4, prompt 1024, 32 greedy steps). Then
    the f32 model's prefill logits, flash against xla."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(registry.get("gemma-2b"),
                              attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(gen, cfg)
    n_params = transformer.count_params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_T),
                           generator=gen, device=dev)
    serve.generate(params, cfg, tokens, 2)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    def run(steps):
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        ids = serve.generate(params, cfg, tokens, steps)
        torch.cuda.synchronize()
        return ids, (time.perf_counter() - t0) * 1e3, \
            fa.flash_attention.launches

    # the main path, counted: every flash launch of one generate call
    torch.cuda.reset_peak_memory_stats()
    ids, total_ms, launches = run(SERVE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers:
        raise AssertionError(f"generate launched flash attention "
                             f"{launches} times, want {cfg.num_layers}: "
                             "one per layer of the prefill, none in decode")
    if ids.shape != (SERVE_B, SERVE_STEPS) or not bool(
            ((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(ids.shape)} ids "
                             "outside the vocabulary")
    pre = [run(1) for _ in range(3)]  # the prefill alone, three times
    if any(p[2] != cfg.num_layers for p in pre) or not all(
            torch.equal(p[0], ids[:, :1]) for p in pre):
        raise AssertionError("a prefill alone launched another count or "
                             "chose another first token")
    prefill_ms = float(np.median([p[1] for p in pre]))
    decode_ms = (total_ms - prefill_ms) / (SERVE_STEPS - 1)
    prof = profile_whole(lambda: serve.generate(params, cfg, tokens, 1), 2)
    # bf16 attention must run on the tensor-core kernel, none on the f32 one
    by_kernel = prof["ported_by_kernel_us"]
    flash_us = by_kernel.get(fa.KERNELS[torch.bfloat16], 0.0)
    if not (flash_us > 0 and prof["kernel_time_sum_us"] > 0) or \
            by_kernel.get(fa.KERNELS[torch.float32], 0.0) > 0:
        raise AssertionError(f"the profiled bf16 prefill shows ported "
                             f"kernels {by_kernel}: want device time for "
                             f"{fa.KERNELS[torch.bfloat16]} and none for "
                             f"{fa.KERNELS[torch.float32]}")
    # two decode steps from a prefilled cache, profiled: where decode's
    # time goes (device events per step, idle share)
    with torch.no_grad():
        _, _, cache = transformer.forward(
            params, cfg, {"tokens": tokens}, mode="prefill",
            max_len=SERVE_T + SERVE_STEPS)
        tok = ids[:, :1]
        prof_decode = profile_device(lambda: [transformer.decode_step(
            params, cfg, tok, cache, SERVE_T + i) for i in range(2)])
    del cache

    # bf16: the flash-vs-xla gap of the prefill logits, printed, not held
    xcfg = dataclasses.replace(cfg, attention_impl="xla")
    with torch.no_grad():
        lf, _, _ = transformer.forward(params, cfg, {"tokens": tokens},
                                       mode="prefill")
        lx, _, _ = transformer.forward(params, xcfg, {"tokens": tokens},
                                       mode="prefill")
        bf16_gap = max(float((lf[i].float() - lx[i].float()).abs().max())
                       for i in range(SERVE_B))
        bf16_same_argmax = float((lf[:, -1].argmax(-1) == lx[:, -1].argmax(
            -1)).float().mean())
        logits_finite = bool(torch.isfinite(lf).all())
    del params, lf, lx
    torch.cuda.empty_cache()
    if not logits_finite:
        raise AssertionError("the bf16 prefill logits are not finite")

    # f32: the flash path's prefill logits against xla's, held
    fcfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = transformer.init_params(gen, fcfg)
    ptok = torch.randint(0, cfg.vocab_size, (PARITY_B, PARITY_T),
                         generator=gen, device=dev)
    fa.flash_attention.launches = 0
    with torch.no_grad():
        lf, _, _ = transformer.forward(params, fcfg, {"tokens": ptok},
                                       mode="prefill")
        f32_launches = fa.flash_attention.launches
        if f32_launches != cfg.num_layers:
            raise AssertionError("the f32 flash prefill did not run the "
                                 "kernel once per layer")
        xfcfg = dataclasses.replace(fcfg, attention_impl="xla")
        lx, _, _ = transformer.forward(params, xfcfg, {"tokens": ptok},
                                       mode="prefill")
        f32_abs, f32_excess = allclose_err(lf, lx, PARITY_TOL)
        del lf, lx
        f32_prefill_ms = {}  # median of 3 prefills each, after the above
        for impl, c in (("flash", fcfg), ("xla", xfcfg)):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                transformer.forward(params, c, {"tokens": ptok},
                                    mode="prefill")
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            f32_prefill_ms[impl] = float(np.median(runs))
    del params
    torch.cuda.empty_cache()
    if not f32_excess <= 1.0:
        raise AssertionError(f"f32 prefill logits: flash vs xla max |d| "
                             f"{f32_abs}, {f32_excess}x the tolerance")

    out = {"phase": "serve", "model": cfg.name, "params": n_params,
           "dtype": cfg.dtype, "batch": SERVE_B, "prompt": SERVE_T,
           "steps": SERVE_STEPS, "flash_launches": launches,
           "generate_ms": total_ms, "prefill_ms": prefill_ms,
           "prefill_ms_runs": [p[1] for p in pre],
           "decode_ms_per_step": decode_ms,
           "prefill_tokens_per_s": SERVE_B * SERVE_T / prefill_ms * 1e3,
           "decode_tokens_per_s": SERVE_B / decode_ms * 1e3,
           "max_memory_allocated": peak,
           "flash_share_of_prefill_kernel_time":
               flash_us / prof["kernel_time_sum_us"],
           "flash_us_in_prefill": flash_us,
           "sample_ids": ids[0, :12].tolist(),
           "bf16_flash_vs_xla_max_abs": bf16_gap,
           "bf16_flash_vs_xla_same_last_argmax": bf16_same_argmax,
           "f32_parity": {"batch": PARITY_B, "prompt": PARITY_T,
                          "tol": PARITY_TOL, "max_abs": f32_abs,
                          "excess": f32_excess,
                          "flash_launches": f32_launches,
                          "prefill_ms": f32_prefill_ms},
           "profile_prefill": prof, "profile_decode_2_steps": prof_decode}
    emit(out)
    return out


def phase_ops(wa, gd, ops, dev, nodes, test) -> dict:
    """kernels/ops.py on a real f32 CNN round: the tree view of the
    (K, N) buffer that the round's flat engine passed to round_stats,
    and its global delta g. tree_vdot_batched must give that round's
    dots, and tree_dot_and_norms per client its squared norms and
    ||g||^2, to 1e-5 normalised."""
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.core import treemath

    server = repro_torch.FedServer("cnn", slice_config("f32"), nodes, test,
                                   batch_size=50, device=dev)
    seen = []
    real = fl_mod.round_stats

    def capture(x, g, mask=None):
        out = real(x, g, mask)
        seen.append((x, g, mask, out))
        return out

    fl_mod.round_stats = capture
    try:
        server.step(eval_every=0)
    finally:
        fl_mod.round_stats = real
    torch.cuda.synchronize()
    if len(seen) != 1 or seen[0][2] is not None:
        raise AssertionError(f"captured {len(seen)} round_stats calls")
    x, g, _, (dots, sqs, sqg) = seen[0]
    template = {key: p[None] for key, p in server.params.items()}
    xs = treemath.tree_unravel_stacked(template, x)
    gs = treemath.tree_map(lambda z: z[0],
                           treemath.tree_unravel_stacked(template, g[None]))
    k = x.shape[0]

    # the ops path, counted
    wa.batched_dot.launches = gd.grad_dot_stats.launches = 0
    u = ops.tree_vdot_batched(xs, gs)
    per_client = [ops.tree_dot_and_norms(
        treemath.tree_map(lambda z: z[i], xs), gs) for i in range(k)]
    torch.cuda.synchronize()
    launches = {"batched_dot": wa.batched_dot.launches,
                "grad_dot_stats": gd.grad_dot_stats.launches}
    leaves = len(treemath.tree_leaves(gs))
    if launches != {"batched_dot": leaves, "grad_dot_stats": k * leaves}:
        raise AssertionError(f"ops launched {launches} for {leaves} leaves "
                             f"and K = {k}")
    # the device kernels of one client's tree_dot_and_norms call (clients
    # 0 and 1: rows 0 and 8 bytes past a 16-byte boundary): one a leaf of
    # at most one block, two a larger leaf, beside the PyTorch ops that
    # add the leaves' sums
    sizes = [z.numel() for z in treemath.tree_leaves(gs)]
    want = len(sizes) + sum(z > GDOT_SPAN for z in sizes)
    per_call = {}
    for i in (0, 1):
        ran = device_kernels(lambda: ops.tree_dot_and_norms(
            treemath.tree_map(lambda z: z[i], xs), gs))
        per_call[i] = {"grad_dot": sum(c for key, c in ran
                                       if GDOT_KERNEL in key
                                       or SUM_KERNEL in key),
                       "all": sum(c for _, c in ran), "kernels": ran}
        if per_call[i]["grad_dot"] != want:
            raise AssertionError(f"client {i}'s tree_dot_and_norms ran "
                                 f"{ran}: want {want} grad_dot_stats "
                                 f"kernels for leaves of {sizes}")
    xd, gd64 = x.double(), g.double()
    dot_scale = (xd.abs() * gd64.abs()[None]).sum(1)
    errs = {
        "vdot_vs_round_dots": sums_err([u], [dots], [dot_scale])[1],
        "tree_dots_vs_round_dots": sums_err(
            [torch.stack([c[0] for c in per_client])], [dots],
            [dot_scale])[1],
        "tree_sqs_vs_round_sqs": sums_err(
            [torch.stack([c[1] for c in per_client])], [sqs],
            [sqs.double().abs()])[1],
        "tree_sqg_vs_round_sqg": max(
            sums_err([c[2]], [sqg], [sqg.double().abs()])[1]
            for c in per_client)}
    out = {"phase": "ops", "model": "cnn", "clients": k,
           "params": x.shape[1], "leaves": leaves, "leaf_sizes": sizes,
           "launches": launches, "norm_err": errs,
           "device_kernels_of_one_client_call": per_call}
    emit(out)
    bad = {key: e for key, e in errs.items() if not e <= TOL}
    if bad:
        raise AssertionError(f"ops disagree with the round's round_stats: "
                             f"{bad}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import transport as tq
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attn as fa
        from repro_torch.kernels import grad_dot as gd
        from repro_torch.kernels import ops
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
    logs = _build.build(SOURCES)  # one nvcc per source, all at once
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    # both flash kernels must run on the tensor cores: mma in their SASS
    mma = {dt: {fn: c["HMMA"] + c["HGMMA"] for fn, c in sass_counts(
        _build.library_path("flash_attn"), fa.KERNELS[dt],
        ("HMMA", "HGMMA")).items()}
        for dt in (torch.bfloat16, torch.float32)}
    # the wire kernels, the bf16 statistics and grad_dot: 16-byte loads
    # (and in the wire kernels no integer-to-float conversion)
    wire_sass = {}
    for source, (kernels, _) in SASS_INSTANCES.items():
        regs = kernel_registers(source, logs)
        wire_sass[source] = {}
        for kernel in kernels:
            for fn, c in sass_counts(_build.library_path(source), kernel,
                                     ("I2F", "LDG.E.128")).items():
                wire_sass[source][fn] = {"registers": regs.get(fn), **c}
    # the bf16 statistics' grid at the main shape: one wave, unmasked
    wave = bf16_stats_wave(rs, wire_sass["round_stats"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas,
          "flash_sass_mma_count": {fa.KERNELS[dt]: c
                                   for dt, c in mma.items()},
          "wire_sass": wire_sass, "bf16_stats_wave": wave})
    for dt, counts in mma.items():
        if len(counts) != len(fa.HEAD_DIMS) or not all(counts.values()):
            raise AssertionError(f"{fa.KERNELS[dt]}: want HMMA or HGMMA in "
                                 f"each of {len(fa.HEAD_DIMS)} head-dim "
                                 f"instances, got {counts}")
    for source, (_, want) in SASS_INSTANCES.items():
        counts = wire_sass[source]
        if len(counts) != want or any(
                (source in NO_I2F and c["I2F"]) or not c["LDG.E.128"]
                for c in counts.values()):
            raise AssertionError(f"{source}: want {want} kernel instances "
                                 f"with 16-byte loads in their SASS (and "
                                 f"no I2F in {NO_I2F}): {counts}")
    if not wave["one_wave"]:
        raise AssertionError(f"the bf16 statistics' main grid needs more "
                             f"than one wave: {wave}")

    table = phase_kernels(wa, rs, tq, dev)
    lm_table = {**phase_ops_kernels(wa, gd, dev),
                **phase_flash_kernel(fa, dev)}
    phase_wire(tq, dev)
    nodes, test = image_task()
    launches = {t: phase_slice(wa, rs, tq, dev, nodes, test, t)
                for t in WIRES}
    phase_error_feedback(nodes, test, dev)
    phase_algorithm(dev, nodes, test)
    serve_out = phase_serve(fa, dev)
    ops_launches = phase_ops(wa, gd, ops, dev, nodes, test)

    for name, row in table.items():
        # each row's launches: its wrapper's count on its own wire's path
        wrapper = name[:-len("_bf16")] if name.endswith("_bf16") else name
        row["launches"] = launches[row["wire"]][wrapper]
    # the LM kernels' launches: serving's generate call, and the ops path
    # (bf16 in the generate call, f32 in the f32 model's prefill)
    lm_table["flash_attention"]["launches"] = serve_out["flash_launches"]
    lm_table["flash_attention_f32"]["launches"] = \
        serve_out["f32_parity"]["flash_launches"]
    for name in ("batched_dot", "grad_dot_stats"):
        lm_table[name]["launches"] = ops_launches[name]
    lm_table["grad_dot_stats_off8"]["launches"] = \
        ops_launches["grad_dot_stats"]
    table.update(lm_table)
    for name, row in table.items():
        if row["launches"] == 0:
            raise AssertionError(f"{name} never launched on its path")
    print(json.dumps({"kernels": list(table.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
