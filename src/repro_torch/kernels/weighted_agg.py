"""K-way weighted aggregation y[n] = sum_k w[k] x[k, n] over the round's
flat (K, N) client-delta buffer (the FedAdp global update), on every wire
of the uplink:

* `weighted_agg(w, x)`: x f32 (the f32 wire) or bf16 (the bf16 wire),
  CUDA source `csrc/weighted_agg.cu`; it replaces the Pallas kernel
  `repro/kernels/weighted_agg.py::weighted_agg` (`_agg_kernel`).
* `weighted_agg_q(w, values, scales)`: the int8 wire, and
  `weighted_agg_q4(w, values, scales, n=, group_size=)`: the packed int4
  wire, both dequantized in registers, CUDA source `csrc/weighted_agg_q.cu`;
  they replace `weighted_agg_q` (`_agg_q_kernel`) and `weighted_agg_q4`
  (`_agg_q4_kernel`) of the same file.
* `batched_dot(x, g)`: u[k] = <x_k, g>, x f32 or bf16 rows read in place
  through their row stride, CUDA source `csrc/batched_dot.cu`; it
  replaces `batched_dot` (`_bdot_kernel`) of the same file. It lies on no
  round path: `kernels/ops.py::tree_vdot_batched` calls it.

All of them are bound by bytes: one read of the wire and one write of y
(the source files' headers have the designs). Sums are f32, y is f32 for
the quantized wires.

A wrapper takes its plain version (`*_plain`) only for tensors that lie
on the CPU. On a CUDA tensor it launches the kernel or raises: there is
no size threshold and no fallback, so every launch on the card is the
kernel. `<wrapper>.launches` counts each wrapper's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.transport.quantize import (
    CHUNK,
    num_chunks,
    num_groups,
    unpack_int4,
    validate_group_size,
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # w, x, y, K, N, stream
    "repro_weighted_agg_f32": [_P, _P, _P, _I, _L, _P],
    "repro_weighted_agg_bf16": [_P, _P, _P, _I, _L, _P],
    # ws, q, y, K, N, C, stream
    "repro_weighted_agg_q8": [_P, _P, _P, _I, _L, _I, _P],
    # ws, q, y, K, n, G, log2(group_size), stream
    "repro_weighted_agg_q4": [_P, _P, _P, _I, _L, _I, _I, _P],
    # x, g, part, out, K, N, ld, x_bf16, g_bf16, blocks, stream
    "repro_batched_dot": [_P, _P, _P, _P, _I, _L, _L, _I, _I, _L, _P],
}


def _fn(source: str, name: str):
    fn = getattr(_build.load(source), name)
    fn.argtypes, fn.restype = _SIGNATURES[name], ctypes.c_int
    return fn


def _launch(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"at arguments {args[3:]}")


# ---------------------------------------------------------------- f32 / bf16


def weighted_agg_plain(w: torch.Tensor, x: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """The reference math (`repro/kernels/ref.py::weighted_agg`) in plain
    torch: f32 products summed over the client axis, cast to `out_dtype`
    (default x.dtype)."""
    y = (w.to(torch.float32)[:, None] * x.to(torch.float32)).sum(0)
    return y.to(out_dtype or x.dtype)


_WIRE_FN = {torch.float32: "repro_weighted_agg_f32",
            torch.bfloat16: "repro_weighted_agg_bf16"}


def _check(w: torch.Tensor, x: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"weighted_agg: w on {w.device} and x on {x.device}; both must "
            "be on one CUDA device (CPU tensors take the plain version)")
    if x.dtype not in _WIRE_FN or w.dtype != torch.float32:
        raise TypeError(
            f"weighted_agg: the kernel takes f32 w and f32 or bf16 x, got "
            f"{w.dtype} and {x.dtype}")
    if x.ndim != 2 or w.shape != (x.shape[0],):
        raise ValueError(
            f"weighted_agg: want x (K, N) and w (K,), got {tuple(x.shape)} "
            f"and {tuple(w.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"weighted_agg: empty x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("weighted_agg: x and w must be contiguous")


def weighted_agg(w: torch.Tensor, x: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """y (N,) = sum_k w[k] x[k, :] for x (K, N) f32 or bf16, accumulated
    in f32 and cast to `out_dtype` (default x.dtype, as the reference).

    CPU tensors: the plain version. CUDA tensors: the kernel, on the
    current stream, without synchronising; anything it does not take
    (another dtype, not contiguous, wrong shapes) raises."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return weighted_agg_plain(w, x, out_dtype)
    _check(w, x)
    k, n = x.shape
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    name = _WIRE_FN[x.dtype]
    _launch(_fn("weighted_agg", name), name, x.device, w.data_ptr(),
            x.data_ptr(), y.data_ptr(), k, n)
    weighted_agg.launches += 1
    out_dtype = out_dtype or x.dtype
    return y if out_dtype == torch.float32 else y.to(out_dtype)


weighted_agg.launches = 0


# ---------------------------------------------------------------- int8 / int4


def _fold(w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(K, C) weight x dequant scale, one multiplier per (client, scale
    column), folded before the pass as the reference does."""
    return (w.to(torch.float32)[:, None] * scales.to(torch.float32)
            ).contiguous()


def _check_wire_shapes(name: str, w: Optional[torch.Tensor],
                       values: torch.Tensor, scales: torch.Tensor,
                       want_scales: int) -> None:
    if values.ndim != 2 or values.shape[0] < 1 or values.shape[1] < 1:
        raise ValueError(f"{name}: want non-empty values (K, width), got "
                         f"{tuple(values.shape)}")
    k = values.shape[0]
    if scales.shape != (k, want_scales):
        raise ValueError(f"{name}: scales must be ({k}, {want_scales}), got "
                         f"{tuple(scales.shape)}")
    if w is not None and w.shape != (k,):
        raise ValueError(f"{name}: w must be ({k},), got {tuple(w.shape)}")


def _check_packed(name: str, values: torch.Tensor, n: int,
                  group_size: int) -> None:
    validate_group_size(group_size)
    if values.ndim != 2 or n < 1 or values.shape[1] != -(-n // 2):
        raise ValueError(
            f"{name}: the packed int4 wire of n={n} logical columns is "
            f"{-(-n // 2)} bytes wide, got values {tuple(values.shape)}")


def _check_cuda_wire(name: str, values: torch.Tensor,
                     *others: torch.Tensor) -> None:
    for t in (values,) + others:
        if t.device.type != "cuda" or t.device != values.device:
            raise ValueError(
                f"{name}: every tensor must be on one CUDA device, got "
                f"{t.device} beside values on {values.device} (CPU tensors "
                "take the plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if values.dtype != torch.int8:
        raise TypeError(f"{name}: the wire values must be int8, got "
                        f"{values.dtype}")
    for t in others:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: w, scales, g and mask must be f32, "
                            f"got {t.dtype}")


def weighted_agg_q_plain(w: torch.Tensor, values: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k (w[k] * scales[k, n // CHUNK]) * values[k, n] in plain
    torch (the kernel's arithmetic: the weight folded into the scale)."""
    n = values.shape[1]
    ws = _fold(w, scales).repeat_interleave(CHUNK, dim=1)[:, :n]
    return (ws * values.to(torch.float32)).sum(0)


def weighted_agg_q(w: torch.Tensor, values: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """y (N,) f32 = sum_k w[k] * scales[k, n // CHUNK] * values[k, n] for
    the int8 wire: values (K, N) int8, scales (K, ceil(N / CHUNK)) f32
    (`transport.quantize(..., "int8")`).

    CPU tensors: the plain version. CUDA tensors: the kernel, on the
    current stream, without synchronising, or a raise."""
    _check_wire_shapes("weighted_agg_q", w, values, scales,
                       num_chunks(values.shape[1]))
    if all(t.device.type == "cpu" for t in (w, values, scales)):
        return weighted_agg_q_plain(w, values, scales)
    _check_cuda_wire("weighted_agg_q", values, w, scales)
    k, n = values.shape
    ws = _fold(w, scales)
    y = torch.empty(n, dtype=torch.float32, device=values.device)
    name = "repro_weighted_agg_q8"
    _launch(_fn("weighted_agg_q", name), name, values.device, ws.data_ptr(),
            values.data_ptr(), y.data_ptr(), k, n, ws.shape[1])
    weighted_agg_q.launches += 1
    return y


weighted_agg_q.launches = 0


def weighted_agg_q4_plain(w: torch.Tensor, values: torch.Tensor,
                          scales: torch.Tensor, *, n: int,
                          group_size: int) -> torch.Tensor:
    """y[m] = sum_k (w[k] * scales[k, m // group_size]) * nibble[k, m] in
    plain torch, for the n logical columns (the odd-N padding nibble
    dropped)."""
    nib = unpack_int4(values)[:, :n].to(torch.float32)
    ws = _fold(w, scales).repeat_interleave(group_size, dim=1)[:, :n]
    return (ws * nib).sum(0)


def weighted_agg_q4(w: torch.Tensor, values: torch.Tensor,
                    scales: torch.Tensor, *, n: int,
                    group_size: int) -> torch.Tensor:
    """y (n,) f32 = sum_k w[k] * scales[k, m // group_size] * nibble[k, m]
    for the packed int4 wire: values (K, ceil(n/2)) int8, two params per
    byte, low nibble first; scales (K, ceil(n / group_size)) f32
    (`transport.quantize(..., "int4")`); group_size an even divisor of
    CHUNK.

    CPU tensors: the plain version. CUDA tensors: the kernel, on the
    current stream, without synchronising, or a raise."""
    _check_packed("weighted_agg_q4", values, n, group_size)
    _check_wire_shapes("weighted_agg_q4", w, values, scales,
                       num_groups(n, group_size))
    if all(t.device.type == "cpu" for t in (w, values, scales)):
        return weighted_agg_q4_plain(w, values, scales, n=n,
                                     group_size=group_size)
    _check_cuda_wire("weighted_agg_q4", values, w, scales)
    k = values.shape[0]
    ws = _fold(w, scales)
    y = torch.empty(n, dtype=torch.float32, device=values.device)
    name = "repro_weighted_agg_q4"
    _launch(_fn("weighted_agg_q", name), name, values.device, ws.data_ptr(),
            values.data_ptr(), y.data_ptr(), k, n, ws.shape[1],
            int(math.log2(group_size)))
    weighted_agg_q4.launches += 1
    return y


weighted_agg_q4.launches = 0


# ---------------------------------------------------------------- batched dot


def batched_dot_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """u (K,) f32 = x @ g in f32 (`repro/kernels/ref.py::batched_dot`)."""
    return x.to(torch.float32) @ g.to(torch.float32)


def batched_dot(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """u[k] = <x[k], g> in f32 for x (K, N) and g (N,), each f32 or bf16.
    x's rows may be a view into a wider buffer (any row stride, columns
    contiguous): the kernel reads them in place.

    CPU tensors: the plain version. CUDA tensors: the kernel (two
    launches, counted once), on the current stream, without
    synchronising, or a raise."""
    if x.ndim != 2 or g.shape != (x.shape[1],) or x.numel() == 0:
        raise ValueError(f"batched_dot: want x (K, N) and g (N,), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.device.type == "cpu" and g.device.type == "cpu":
        return batched_dot_plain(x, g)
    for t in (x, g):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(
                f"batched_dot: x on {x.device} and g on {g.device}; both "
                "must be on one CUDA device (CPU tensors take the plain "
                "version)")
        if t.dtype not in _WIRE_FN:
            raise TypeError(f"batched_dot: the kernel takes f32 or bf16, "
                            f"got {t.dtype}")
    k, n = x.shape
    ld = x.stride(0) if k > 1 else n  # a single row's stride is moot
    if x.stride(1) != 1 or ld < n or not g.is_contiguous():
        raise ValueError("batched_dot: x's columns and g must be contiguous")
    lib = _build.load("batched_dot")
    blocks_for = lib.repro_batched_dot_blocks
    blocks_for.argtypes, blocks_for.restype = [_L], _L
    nblocks = blocks_for(n)
    part = torch.empty(nblocks * k, dtype=torch.float32, device=x.device)
    u = torch.empty(k, dtype=torch.float32, device=x.device)
    name = "repro_batched_dot"
    _launch(_fn("batched_dot", name), name, x.device, x.data_ptr(),
            g.data_ptr(), part.data_ptr(), u.data_ptr(), k, n, ld,
            int(x.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
            nblocks)
    batched_dot.launches += 1
    return u


batched_dot.launches = 0
