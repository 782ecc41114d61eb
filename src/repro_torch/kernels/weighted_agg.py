"""K-way weighted aggregation y[n] = sum_k w[k] x[k, n] over the round's
flat (K, N) f32 client-delta buffer (the FedAdp global update).

The kernel is hand-written CUDA C++ for Hopper, `csrc/weighted_agg.cu`;
it replaces the Pallas kernel `repro/kernels/weighted_agg.py::weighted_agg`
(`_agg_kernel`). It is bound by bytes: one read of x and one write of y,
streamed with one thread per 4 consecutive columns looping over every
client (the source file's header has the design).

`weighted_agg` takes the plain version `weighted_agg_plain` only for
tensors that lie on the CPU. On a CUDA tensor it launches the kernel or
raises: there is no size threshold and no fallback, so every launch on
the card is the kernel. `weighted_agg.launches` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURE = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
              ctypes.c_int)


def _lib():
    lib = _build.load("weighted_agg")
    fn = lib.repro_weighted_agg_f32
    fn.argtypes, fn.restype = _SIGNATURE
    return fn


def weighted_agg_plain(w: torch.Tensor, x: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """The reference math (`repro/kernels/ref.py::weighted_agg`) in plain
    torch: f32 products summed over the client axis."""
    y = (w.to(torch.float32)[:, None] * x.to(torch.float32)).sum(0)
    return y.to(out_dtype)


def _check(w: torch.Tensor, x: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"weighted_agg: w on {w.device} and x on {x.device}; both must "
            "be on one CUDA device (CPU tensors take the plain version)")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(
            f"weighted_agg: the kernel takes f32 w and x, got {w.dtype} and "
            f"{x.dtype}")
    if x.ndim != 2 or w.shape != (x.shape[0],):
        raise ValueError(
            f"weighted_agg: want x (K, N) and w (K,), got {tuple(x.shape)} "
            f"and {tuple(w.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"weighted_agg: empty x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("weighted_agg: x and w must be contiguous")


def weighted_agg(w: torch.Tensor, x: torch.Tensor, *,
                 out_dtype=torch.float32) -> torch.Tensor:
    """y (N,) = sum_k w[k] x[k, :] for x (K, N), accumulated in f32.

    CPU tensors: the plain version. CUDA tensors: the kernel, on the
    current stream, without synchronising; anything it does not take (not
    f32, not contiguous, wrong shapes) raises. `out_dtype` casts the f32
    result."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return weighted_agg_plain(w, x, out_dtype)
    _check(w, x)
    k, n = x.shape
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(w.data_ptr(), x.data_ptr(), y.data_ptr(), k, n, stream)
    if err:
        raise RuntimeError(f"weighted_agg kernel launch failed: CUDA error "
                           f"{err} at K={k}, N={n}")
    weighted_agg.launches += 1
    return y if out_dtype == torch.float32 else y.to(out_dtype)


weighted_agg.launches = 0
