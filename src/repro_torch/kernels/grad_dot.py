"""Gradient statistics (<a, b>, ||a||^2, ||b||^2) of two equally shaped
arrays in one pass, f32 accumulate: FedAdp's angle inputs for one client
against the global update, over a parameter leaf.

`grad_dot_stats(a, b)` replaces the Pallas kernel
`repro/kernels/grad_dot.py::grad_dot_stats` (`_kernel`); CUDA source
`csrc/grad_dot.cu` (a fixed split into blocks of 2,048 elements: one
launch for one block, else a fixed-order second stage as a programmatic
dependent launch, so the sums are the same from run to run; 16-byte
loads at any offset of a and b). It lies on no round path:
`kernels/ops.py::tree_dot_and_norms` calls it.

The wrapper takes the plain version only for tensors that lie on the
CPU. On CUDA tensors it launches the kernel or raises.
`grad_dot_stats.launches` counts its calls on the card (one per call,
whatever the number of launches).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def grad_dot_stats_plain(a: torch.Tensor, b: torch.Tensor):
    """(<a,b>, ||a||^2, ||b||^2) as f32 scalars, plain torch
    (`repro/kernels/ref.py::grad_dot_stats`)."""
    af = a.reshape(-1).to(torch.float32)
    bf = b.reshape(-1).to(torch.float32)
    return torch.dot(af, bf), torch.dot(af, af), torch.dot(bf, bf)


def grad_dot_stats(a: torch.Tensor, b: torch.Tensor):
    """(<a,b>, ||a||^2, ||b||^2) for equally shaped a and b, f32
    accumulate; three f32 scalar tensors.

    CPU tensors: the plain version. CUDA tensors: the kernel, on the
    current stream, without synchronising; a and b must be contiguous,
    non-empty and both f32 or both bf16."""
    if a.shape != b.shape:
        raise ValueError(f"grad_dot_stats: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ in shape")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return grad_dot_stats_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"grad_dot_stats: a on {a.device} and b on {b.device}; both "
            "must be on one CUDA device (CPU tensors take the plain "
            "version)")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"grad_dot_stats: the kernel takes a and b both f32 "
                        f"or both bf16, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()) or a.numel() == 0:
        raise ValueError("grad_dot_stats: a and b must be contiguous and "
                         "non-empty")
    n = a.numel()
    lib = _build.load("grad_dot")
    blocks_for, fn = lib.repro_grad_dot_blocks, lib.repro_grad_dot
    blocks_for.argtypes, blocks_for.restype = [_L], _L
    fn.argtypes, fn.restype = [_P, _P, _P, _P, _L, _I, _L, _P], _I
    nblocks = blocks_for(n)
    # one block writes out itself and needs no partials
    part = torch.empty(nblocks * 3, dtype=torch.float32,
                       device=a.device) if nblocks > 1 else None
    out = torch.empty(3, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if part is None else part.data_ptr(), out.data_ptr(),
                 n, int(a.dtype == torch.bfloat16), nblocks, stream)
    if err:
        raise RuntimeError(f"grad_dot_stats kernel launch failed: CUDA error "
                           f"{err} at n={n}")
    grad_dot_stats.launches += 1
    return out[0], out[1], out[2]


grad_dot_stats.launches = 0
