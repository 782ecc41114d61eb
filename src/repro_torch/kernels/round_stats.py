"""Per-round angle statistics in one pass over the round's flat (K, N)
client-delta buffer x and the global delta g (N,):
dots[k] = <x_k, g>, sqs[k] = ||x_k||^2, sqg = ||g||^2, optionally over
the subspace of an (N,) 0/1 segment mask (angle_filter="dense_only"), on
every wire of the uplink:

* `round_stats(x, g, mask)`: x f32 or bf16 (the bf16 wire), CUDA source
  `csrc/round_stats.cu`, one design with a kernel for each type; it
  replaces the Pallas kernels `repro/kernels/round_stats.py::round_stats`
  (`_stats_kernel`, `_stats_kernel_masked`).
* `round_stats_q(values, scales, g, mask)`: the int8 wire, and
  `round_stats_q4(values, scales, g, mask, group_size=)`: the packed int4
  wire, both dequantized in registers, CUDA source `csrc/round_stats_q.cu`;
  they replace `round_stats_q` (`_stats_q_kernel{,_masked}`) and
  `round_stats_q4` (`_stats_q4_kernel{,_masked}`) of the same file.

All are bound by bytes: one read of x or the wire plus g (and the
mask). Each reduces per column block into 2K+1 partials a block, and a
second launch, a programmatic dependent one whose blocks start before
the first grid ends, reduces those in a fixed order, so the result is
the same from run to run (the source files' headers have the designs).
g and the mask are f32 and in logical columns; sums are f32.

A wrapper takes its plain version (`*_plain`) only for tensors that lie
on the CPU (or on the meta device, which has no data: the dry run's
sequential round). On a CUDA tensor it launches the kernels or raises.
`<wrapper>.launches` counts each wrapper's calls on the card (one per
call, whatever the number of launches).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.weighted_agg import (
    _check_cuda_wire,
    _check_packed,
    _check_wire_shapes,
)
from repro_torch.transport.quantize import (
    QuantizedDelta,
    dequantize,
    num_chunks,
    num_groups,
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, g, mask, part, out, K, N, stream
    "repro_wire_stats_f32": [_P, _P, _P, _P, _P, _I, _L, _P],
    "repro_wire_stats_bf16": [_P, _P, _P, _P, _P, _I, _L, _P],
    # K, N, bytes an element of x (4: f32, 2: bf16) -> floats of part
    "repro_round_stats_floats": [_I, _L, _I],
    # q, scales, g, mask, part, out, K, N, C, stream
    "repro_wire_stats_q8": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _P],
    # q, scales, g, mask, part, out, K, n, G, log2(group_size), stream
    "repro_wire_stats_q4": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P],
    # K, n, lg (0: the int8 wire) -> floats of part
    "repro_wire_stats_floats": [_I, _L, _I],
}
_RETURNS = {"repro_wire_stats_floats": _L, "repro_round_stats_floats": _L}


def _fn(source: str, name: str):
    fn = getattr(_build.load(source), name)
    fn.argtypes, fn.restype = _SIGNATURES[name], _RETURNS.get(name, _I)
    return fn


def _raise_on(err: int, name: str, sizes) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"at K, N, ... = {sizes}")


def _launch(source: str, name: str, k: int, floats: int, device, ptrs,
            sizes):
    """One call of a statistics entry point `name` of `source` with fresh
    scratch of `floats` floats. Returns (dots, sqs, sqg)."""
    part = torch.empty(floats, dtype=torch.float32, device=device)
    out = torch.empty(2 * k + 1, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(source, name)(*ptrs, part.data_ptr(), out.data_ptr(),
                                *sizes, stream)
    _raise_on(err, name, sizes)
    return out[:k], out[k:2 * k], out[2 * k]


def _run_wire(name: str, k: int, n: int, lg: int, device, ptrs, sizes):
    """The two launches of a wire statistics kernel (lg = 0: int8, else
    int4 at group size 2^lg)."""
    floats = _fn("round_stats_q", "repro_wire_stats_floats")(k, n, lg)
    return _launch("round_stats_q", name, k, floats, device, ptrs, sizes)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on(kind: str, *ts) -> bool:
    """Do the tensors all lie on devices of `kind`?"""
    return {t.device.type for t in ts if t is not None} == {kind}


def _meta_out(k: int):
    """A statistics call's outputs on the meta device, as the CUDA path
    allocates them and with no launch: the dry run traces the step
    around the kernel (`launch/dryrun.py`; the kernel's scratch, a few
    floats a block, is not allocated)."""
    out = torch.empty(2 * k + 1, dtype=torch.float32, device="meta")
    return out[:k], out[k:2 * k], out[2 * k]


# ---------------------------------------------------------------- f32 / bf16


def round_stats_plain(x: torch.Tensor, g: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
    """The reference math (`repro/kernels/ref.py::round_stats`) in plain
    torch: (dots (K,), sqs (K,), sqg ()) in f32. Every sum is
    `torch.sum` (pairwise on the CPU), never a BLAS gemv or dot, whose f32
    accumulation lost 6e-5 of a dot at N = 6M."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    if mask is not None:
        mf = mask.to(torch.float32)
        xf = xf * mf[None]
        gf = gf * mf
    return (torch.sum(xf * gf[None], dim=1), torch.sum(xf * xf, dim=1),
            torch.sum(gf * gf))


_X_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, g, mask) -> None:
    named = [("x", x), ("g", g)] + ([("mask", mask)] if mask is not None
                                    else [])
    for name, t in named:
        if t.device != x.device or x.device.type != "cuda":
            raise ValueError(
                f"round_stats: {name} on {t.device}, x on {x.device}; all "
                "must be on one CUDA device (CPU tensors take the plain "
                "version)")
        if t.dtype != torch.float32 and not (name == "x"
                                             and t.dtype in _X_DTYPES):
            raise TypeError(f"round_stats: the kernel takes f32 or bf16 x "
                            f"and f32 g and mask, {name} is {t.dtype}")
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
    """(dots (K,), sqs (K,), sqg ()) for x (K, N) f32 or bf16, g (N,),
    mask (N,) or None, accumulated in f32.

    CPU tensors: the plain version. Meta tensors: the outputs' shapes
    (the dry run's). CUDA tensors: the kernel, on the current stream,
    without synchronising; anything it does not take raises."""
    if _on("cpu", x, g, mask):
        return round_stats_plain(x, g, mask)
    if _on("meta", x, g, mask):
        return _meta_out(x.shape[0])
    _check(x, g, mask)
    k, n = x.shape
    name = ("repro_wire_stats_bf16" if x.dtype == torch.bfloat16
            else "repro_wire_stats_f32")
    floats = _fn("round_stats", "repro_round_stats_floats")(
        k, n, x.element_size())
    out = _launch("round_stats", name, k, floats, x.device,
                  (x.data_ptr(), g.data_ptr(), _ptr(mask)), (k, n))
    round_stats.launches += 1
    return out


round_stats.launches = 0


def stats_blocks(k: int, n: int, dtype: torch.dtype) -> int:
    """The blocks of the statistics kernel's grid for x (k, n) of `dtype`
    (f32 or bf16)."""
    floats = _fn("round_stats", "repro_round_stats_floats")(k, n,
                                                            dtype.itemsize)
    return floats // (2 * k + 1)


# ---------------------------------------------------------------- int8 / int4


def _check_vectors(name: str, n: int, g, mask) -> None:
    for vname, t in (("g", g), ("mask", mask)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"{name}: {vname} must be ({n},), got "
                             f"{tuple(t.shape)}")


def round_stats_q_plain(values: torch.Tensor, scales: torch.Tensor,
                        g: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """`round_stats_plain` of the dequantized int8 wire."""
    return round_stats_plain(
        dequantize(QuantizedDelta(values, scales, "int8")), g, mask)


def round_stats_q(values: torch.Tensor, scales: torch.Tensor,
                  g: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """`round_stats` over the int8 wire: values (K, N) int8, scales
    (K, ceil(N / CHUNK)) f32, g and mask (N,) f32. Matches round_stats of
    the dequantized wire up to f32 summation order.

    CPU tensors: the plain version. CUDA tensors: the kernels, on the
    current stream, without synchronising, or a raise."""
    _check_wire_shapes("round_stats_q", None, values, scales,
                       num_chunks(values.shape[1]))
    k, n = values.shape
    _check_vectors("round_stats_q", n, g, mask)
    if _on("cpu", values, scales, g, mask):
        return round_stats_q_plain(values, scales, g, mask)
    if _on("meta", values, scales, g, mask):
        return _meta_out(k)
    _check_cuda_wire("round_stats_q", values, scales, g,
                     *([mask] if mask is not None else []))
    out = _run_wire("repro_wire_stats_q8", k, n, 0, values.device,
                    (values.data_ptr(), scales.data_ptr(), g.data_ptr(),
                     _ptr(mask)), (k, n, scales.shape[1]))
    round_stats_q.launches += 1
    return out


round_stats_q.launches = 0


def round_stats_q4_plain(values: torch.Tensor, scales: torch.Tensor,
                         g: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *,
                         group_size: int):
    """`round_stats_plain` of the dequantized int4 wire (n = len(g))."""
    q = QuantizedDelta(values, scales, "int4", g.shape[0], group_size)
    return round_stats_plain(dequantize(q), g, mask)


def round_stats_q4(values: torch.Tensor, scales: torch.Tensor,
                   g: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                   group_size: int):
    """`round_stats` over the packed int4 wire: values (K, ceil(n/2))
    int8, two params per byte, low nibble first; scales
    (K, ceil(n / group_size)) f32; g and mask (n,) f32 in logical columns
    (n = len(g)); group_size an even divisor of CHUNK.

    CPU tensors: the plain version. CUDA tensors: the kernels, on the
    current stream, without synchronising, or a raise."""
    n = g.shape[0] if g.ndim == 1 else -1
    _check_packed("round_stats_q4", values, n, group_size)
    _check_wire_shapes("round_stats_q4", None, values, scales,
                       num_groups(n, group_size))
    _check_vectors("round_stats_q4", n, g, mask)
    if _on("cpu", values, scales, g, mask):
        return round_stats_q4_plain(values, scales, g, mask,
                                    group_size=group_size)
    if _on("meta", values, scales, g, mask):
        return _meta_out(values.shape[0])
    _check_cuda_wire("round_stats_q4", values, scales, g,
                     *([mask] if mask is not None else []))
    k = values.shape[0]
    lg = int(math.log2(group_size))
    out = _run_wire("repro_wire_stats_q4", k, n, lg, values.device,
                    (values.data_ptr(), scales.data_ptr(), g.data_ptr(),
                     _ptr(mask)), (k, n, scales.shape[1], lg))
    round_stats_q4.launches += 1
    return out


round_stats_q4.launches = 0
