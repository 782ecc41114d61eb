"""Op-trace analysis of a torch program: the counterpart of
`repro/launch/hlo.py` (collective bytes, op histogram) and
`repro/launch/hlo_scoped.py` (loop-aware flops and HBM bytes).

A torch program has no HLO. `OpTrace` is a `TorchDispatchMode` that
records every aten op that reaches the dispatcher below autograd and
`torch.func` (so a backward's ops and a vmapped op's batched form are
seen): its name, its input and output shapes and dtypes, its flops and
bytes, and the storages it allocates. It works on any device, the
"meta" device included, where a whole training step runs without
memory. From the record:

  * flops       — 2*M*N*K for each mm / bmm / addmm / baddbmm, and for
                  each convolution 2 * (output elements) * (input
                  channels a group) * (kernel elements); a
                  convolution_backward counts that once for each
                  gradient it computes; the recurrent blocks' custom
                  ops (`models/mamba.py`'s selective scan,
                  `models/rwkv6.py`'s chunked WKV, and their backward
                  ops) count the products their loop form's trace
                  counted at the same shapes: per step the scan's
                  (R, di, n) x (R, n) product, per chunk the WKV's
                  einsums, each backward twice its forward;
  * hbm_bytes   — operand plus result bytes of every op that is not a
                  view (views launch nothing): each eager op is one
                  kernel boundary, as a fusion is in the reference;
  * collectives — result bytes of each c10d collective op, under the
                  reference's keys (`COLLECTIVES`);
  * peak_bytes  — the peak of the live bytes of the storages allocated
                  inside the trace, by storage (views share one), each
                  freed when its storage is (a weakref finalizer); a
                  recurrent block's op adds the workspace it holds
                  while it runs (`mamba.scan_workspace`,
                  `rwkv6.wkv_workspace`), on every device alike.

`unknown_trip_loops` is always 0: an eager program unrolls every loop,
so every trip is traced.
"""
from __future__ import annotations

import math
import time
import weakref
from collections import Counter, defaultdict
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models import mamba, rwkv6

# a collective's name in the port (c10d's, `ClientMesh`'s) -> its key in
# a record, the reference's HLO opcode (`repro/launch/hlo.py`); broadcast
# is the port's own (XLA's partitioner emits none)
COLLECTIVES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
               "broadcast": "broadcast"}
_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}  # first operand
_COLLECTIVE_NAMES = {"allreduce": "all_reduce", "allgather": "all_gather",
                     "alltoall": "all_to_all"}
_RECURRENT = {"selective_scan", "selective_scan_backward", "wkv_chunked",
              "wkv_chunked_backward"}


class Op(NamedTuple):
    name: str  # e.g. "aten.bmm.default"
    in_shapes: tuple
    out_shapes: tuple
    dtypes: tuple  # the outputs'
    flops: float
    bytes: int  # operand + result bytes; 0 for a view
    alloc_bytes: int  # bytes of the storages this op allocated


class BudgetExceeded(RuntimeError):
    """The traced program ran past the trace's time budget."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mm_flops(a_shape, b_shape) -> float:
    """2 * batch * M * N * K of a (…, M, K) @ (…, K, N) product."""
    return 2.0 * math.prod(a_shape) * b_shape[-1]


def _conv_flops(w_shape, out_shape) -> float:
    """2 * output elements * (input channels a group) * kernel elements
    (w is (C_out, C_in / groups, *kernel))."""
    return 2.0 * math.prod(out_shape) * math.prod(w_shape[1:])


def op_flops(base: str, args, out) -> float:
    """The flops of one aten op (0 for everything but products and
    convolutions)."""
    if base in _MATMULS:
        i = _MATMULS[base]
        return _mm_flops(tuple(args[i].shape), tuple(args[i + 1].shape))
    if base == "convolution":
        return _conv_flops(tuple(args[1].shape), tuple(out.shape))
    if base in _RECURRENT:
        return recurrent_flops(base, args)
    if base == "convolution_backward":
        # (grad_out, input, weight, ..., output_mask): the input and
        # weight gradients each cost one forward
        per = _conv_flops(tuple(args[2].shape), tuple(args[0].shape))
        return per * sum(bool(m) for m in args[10][:2])
    return 0.0


def _scan_shapes(args, backward: bool) -> tuple:
    """(R, T, di, n) of a selective scan op's call (the backward's
    operands start with the two cotangents)."""
    r, t, di = args[2 if backward else 0].shape
    return r, t, di, args[4 if backward else 2].shape[-1]


def _wkv_shapes(args, backward: bool) -> tuple:
    """(B, nC, L, H, e) of a chunked WKV op's call."""
    return tuple(args[2 if backward else 0].shape)


def recurrent_flops(base: str, args) -> float:
    """The flops of a recurrent block's op: its loop form's products
    (module docstring), 0 for any other op."""
    if base in ("selective_scan", "selective_scan_backward"):
        r, t, di, n = _scan_shapes(args, base != "selective_scan")
        return 2.0 * r * t * di * n * (1 if base == "selective_scan" else 2)
    if base in ("wkv_chunked", "wkv_chunked_backward"):
        b, nc, l_, h, e = _wkv_shapes(args, base != "wkv_chunked")
        per = 2.0 * b * h * nc * (2 * l_ * l_ * e + 2 * l_ * e * e + l_ * e)
        return per * (1 if base == "wkv_chunked" else 2)
    return 0.0


def recurrent_workspace(base: str, args) -> int:
    """The bytes a recurrent block's op holds while it runs beside its
    operands and results (0 for any other op)."""
    if base in ("selective_scan", "selective_scan_backward"):
        back = base != "selective_scan"
        return mamba.scan_workspace(*_scan_shapes(args, back), back)
    if base in ("wkv_chunked", "wkv_chunked_backward"):
        back = base != "wkv_chunked"
        return rwkv6.wkv_workspace(*_wkv_shapes(args, back), back)
    return 0


def _collective(name: str) -> Optional[str]:
    ns, _, rest = name.partition(".")
    if "c10d" not in ns:
        return None
    base = rest.split(".")[0].rstrip("_")
    base = _COLLECTIVE_NAMES.get(base, base)
    return base if base in COLLECTIVES else None


class OpTrace(TorchDispatchMode):
    """Record every aten op run inside `with OpTrace() as trace:`.

    `budget_s` > 0 raises `BudgetExceeded` from the first op past that
    many seconds, so that a program too long to trace fails with its
    cause. `keep_ops` False keeps only the totals."""

    def __init__(self, *, budget_s: float = 0.0, keep_ops: bool = True):
        super().__init__()
        self.ops: list = []
        self.keep_ops = keep_ops
        self.budget_s = budget_s
        self.n_ops = 0
        self.flops = 0.0
        self.hbm_bytes = 0
        self.histogram: Counter = Counter()
        self.coll: dict = defaultdict(int)
        self.coll_n = 0
        self.live = 0
        self.peak = 0
        self._tracked: dict = {}  # id(storage) -> weakref, allocated here
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return super().__enter__()

    def _free(self, key: int, nbytes: int) -> None:
        self._tracked.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.budget_s and time.perf_counter() - self._t0 > self.budget_s:
            raise BudgetExceeded(
                f"the traced program ran past {self.budget_s:.0f} s after "
                f"{self.n_ops} ops")
        ins = [x for x in tree_leaves((args, kwargs))
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        name = str(func)
        base = func._schema.name.split("::")[-1].rstrip("_")  # in place
        flops = op_flops(base, args, out)
        nbytes = 0 if func.is_view else (sum(map(_nbytes, ins))
                                         + sum(map(_nbytes, outs)))
        in_storages = {id(x.untyped_storage()) for x in ins}
        alloc = 0
        for x in outs:
            st = x.untyped_storage()
            key = id(st)
            if key in in_storages or key in self._tracked:
                continue
            size = st.nbytes()
            self._tracked[key] = weakref.ref(st)
            weakref.finalize(st, self._free, key, size)
            self.live += size
            alloc += size
        work = recurrent_workspace(base, args) if base in _RECURRENT else 0
        self.peak = max(self.peak, self.live + work)
        self.n_ops += 1
        self.flops += flops
        self.hbm_bytes += nbytes
        self.histogram[name] += 1
        coll = _collective(name)
        if coll is not None:
            self.coll[COLLECTIVES[coll]] += sum(map(_nbytes, outs))
            self.coll_n += 1
        if self.keep_ops:
            self.ops.append(Op(
                name, tuple(tuple(x.shape) for x in ins),
                tuple(tuple(x.shape) for x in outs),
                tuple(str(x.dtype) for x in outs), flops, nbytes, alloc))
        return out


def collective_bytes(trace: OpTrace) -> dict:
    """Per-collective result-byte totals of the c10d ops in the trace,
    under the record's keys: {"all-reduce": bytes, ..., "total": bytes,
    "count": n_ops}."""
    out = dict(trace.coll)
    out["total"] = sum(out.values())
    out["count"] = trace.coll_n
    return out


def op_histogram(trace: OpTrace, ops=None) -> dict:
    """Op name -> count; with `ops`, only the names that contain one of
    them (e.g. ("mm", "bmm"))."""
    if ops is None:
        return dict(trace.histogram)
    return {name: n for name, n in trace.histogram.items()
            if any(f".{op}." in f".{name}." for op in ops)}


def analyze(trace: OpTrace) -> dict:
    """(flops, hbm_bytes, collective bytes) of a trace, with the
    reference's keys, and its peak of live bytes allocated inside it."""
    return {
        "flops": trace.flops,
        "hbm_bytes": trace.hbm_bytes,
        "collectives": collective_bytes(trace),
        "unknown_trip_loops": 0,
        "peak_bytes": trace.peak,
        "ops": trace.n_ops,
    }
