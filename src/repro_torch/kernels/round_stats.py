"""Per-round angle statistics in one pass over the flat (K, N) f32
client-delta buffer x and the global delta g (N,):
dots[k] = <x_k, g>, sqs[k] = ||x_k||^2, sqg = ||g||^2, optionally over
the subspace of an (N,) 0/1 segment mask (angle_filter="dense_only").

The kernel is hand-written CUDA C++ for Hopper, `csrc/round_stats.cu`;
it replaces the Pallas kernels `repro/kernels/round_stats.py::round_stats`
(`_stats_kernel`, `_stats_kernel_masked`). It is bound by bytes: one
read of x plus g (and the mask). Stage 1 reduces per column block into
(blocks, 2K+1) partials, stage 2 reduces those in a fixed order, so the
result is the same from run to run (the source file's header has the
design).

`round_stats` takes the plain version `round_stats_plain` only for
tensors that lie on the CPU. On a CUDA tensor it launches the kernel or
raises. `round_stats.launches` counts the wrapper's launches (one per
call: both stages together).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_SIGNATURE = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p],
              ctypes.c_int)


def _lib():
    lib = _build.load("round_stats")
    fn = lib.repro_round_stats_f32
    fn.argtypes, fn.restype = _SIGNATURE
    blocks = lib.repro_round_stats_blocks
    blocks.argtypes, blocks.restype = [ctypes.c_longlong], ctypes.c_longlong
    return fn, blocks


def round_stats_plain(x: torch.Tensor, g: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
    """The reference math (`repro/kernels/ref.py::round_stats`) in plain
    torch: (dots (K,), sqs (K,), sqg ()) in f32."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    if mask is not None:
        mf = mask.to(torch.float32)
        xf = xf * mf[None]
        gf = gf * mf
    return xf @ gf, torch.sum(xf * xf, dim=1), torch.dot(gf, gf)


def _check(x, g, mask) -> None:
    named = [("x", x), ("g", g)] + ([("mask", mask)] if mask is not None
                                    else [])
    for name, t in named:
        if t.device != x.device or x.device.type != "cuda":
            raise ValueError(
                f"round_stats: {name} on {t.device}, x on {x.device}; all "
                "must be on one CUDA device (CPU tensors take the plain "
                "version)")
        if t.dtype != torch.float32:
            raise TypeError(f"round_stats: the kernel takes f32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"round_stats: {name} must be contiguous")
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"round_stats: want a non-empty x (K, N), got "
                         f"{tuple(x.shape)}")
    n = x.shape[1]
    for name, t in named[1:]:
        if t.shape != (n,):
            raise ValueError(f"round_stats: {name} must be ({n},), got "
                             f"{tuple(t.shape)}")


def round_stats(x: torch.Tensor, g: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
    """(dots (K,), sqs (K,), sqg ()) for x (K, N), g (N,), mask (N,) or
    None, accumulated in f32.

    CPU tensors: the plain version. CUDA tensors: the kernel, on the
    current stream, without synchronising; anything it does not take
    raises."""
    on_cpu = [t.device.type == "cpu" for t in (x, g, mask) if t is not None]
    if all(on_cpu):
        return round_stats_plain(x, g, mask)
    _check(x, g, mask)
    k, n = x.shape
    fn, blocks_for = _lib()
    nblocks = blocks_for(n)
    part = torch.empty(nblocks * (2 * k + 1), dtype=torch.float32,
                       device=x.device)
    out = torch.empty(2 * k + 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 part.data_ptr(), out.data_ptr(), k, n, nblocks, stream)
    if err:
        raise RuntimeError(f"round_stats kernel launch failed: CUDA error "
                           f"{err} at K={k}, N={n}")
    round_stats.launches += 1
    return out[:k], out[k:2 * k], out[2 * k]


round_stats.launches = 0
