"""Flash attention: a causal or non-causal online-softmax forward that
never writes the (T, T) scores to device memory, and the reference's
recompute backward.

* `flash_attention(q, k, v, causal, blk_q, blk_k)`: q/k/v (BH, T, d);
* `gqa_flash(q, k, v, causal=, blk_q=, blk_k=)`: q (B, T, H, hd), k/v
  (B, T, G, hd) -> (B, T, H, hd).

Both replace `repro/kernels/flash_attn.py` (the Pallas `_kernel` through
`_flash_fwd_impl`, and `gqa_flash`) with the reference's parameters
less `interpret`;
CUDA source `csrc/flash_attn.cu`, one entry point for two kernels
(`KERNELS`): bf16 inputs run `flash_mma_kernel` (`csrc/flash_mma.cuh`),
whose two products are bf16 `wgmma` on the tensor cores with f32
accumulators, fed by TMA, and whose softmax is f32; f32 inputs run
`flash_tf32_kernel`, whose two products are `mma.sync` on the tensor
cores as 3xTF32 (each f32 operand split into two TF32 parts, three
products accumulated in f32: the f32 tolerance, 2e-5, rules out one-pass
TF32, not this). The designs are in the sources' headers. `blk_q` and
`blk_k` keep only the reference's divisibility asserts: the kernels'
tiles are their own; any T >= 1 runs (a ragged last tile is masked). Mismatched shapes raise
ValueError (the reference asserts), so that no shape reaches the kernel
unchecked under `python -O`. `gqa_flash` hands the kernel the KV head of
each query head (h // (H / G)) instead of repeating k and v: the same
function without the copy. The output is in q's dtype.

Both wrappers go through one `torch.autograd.Function` (`_Flash`) on
the (B, T, heads, hd) layout (`flash_attention` views its (BH, T, d) as
(BH, T, 1, d)). Its forward takes the plain version
(`flash_attention_plain`, the naive softmax of
`repro/kernels/ref.py::flash_attention`) only for tensors that lie on
the CPU; on CUDA tensors it launches the kernel or raises. Its backward
is the reference's recompute (`_flash_bwd`, jnp there, not Pallas):
scores, softmax, dv, dp, ds, dq and dk in f32, with dk and dv summed
over each KV group's query heads. Its `vmap` rule folds a vmapped dim
into the batch, so that under `torch.func.vmap(grad)` (the round's K
clients) one launch serves every client and the forward receives plain
tensors, whose storage the ctypes launch reads; a folded tensor is made
contiguous only where the kernel's layout checks need it.
`flash_attention.launches` counts the kernel's forward launches from
either wrapper, of either kernel. Inside a training recompute
(`models/recompute.py`) the output is kept on the recompute's tape, so
the backward's rerun of a group reads it back and launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models import recompute

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)  # the head dims csrc/flash_attn.cu is built for
# the device kernel each input dtype runs, by the name a profiler shows
KERNELS = {torch.bfloat16: "flash_mma_kernel",
           torch.float32: "flash_tf32_kernel"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _P]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Naive softmax attention (the reference oracle): q/k/v (BH, T, d),
    f32 math, masked scores -1e30, output in q's dtype."""
    t = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("btd,bsd->bts", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(t, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.to(torch.float32)).to(q.dtype)


def _fn():
    fn = _build.load("flash_attn").repro_flash_attn
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def _check_cuda(q, k, v) -> None:
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"flash attention: q on {q.device}, k on {k.device}, v on "
                f"{v.device}; all must be on one CUDA device (CPU tensors "
                "take the plain version)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: the kernel takes q, k, v all f32 "
                        f"or all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for t in (q, k, v):
        if not _kernel_layout(t):
            raise ValueError(
                "flash attention: the kernel wants the head dim contiguous "
                "and every row 16-byte aligned")


def _kernel_layout(t: torch.Tensor) -> bool:
    """Is the head dim contiguous and every row 16-byte aligned?"""
    return t.stride(-1) == 1 and not t.data_ptr() % 16 and not any(
        s * t.element_size() % 16 for s in t.stride()[:-1])


def _launch(q, k, v, o, strides, b, h, g, t, d, causal) -> None:
    """Launch the kernel on (B, T, heads, d) arrays given by `strides`
    (batch, head, time per tensor, in elements)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {d} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    arr = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    ctypes.addressof(arr), b, h, g, t, d,
                    int(q.dtype == torch.bfloat16), int(causal),
                    1.0 / (d ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err} at B={b}, H={h}, G={g}, T={t}, "
                           f"d={d}")
    flash_attention.launches += 1


def _gqa_plain(q, k, v, causal):
    """The plain version on (B, T, H, hd) / (B, T, G, hd): each query
    head against its group's KV head, repeated."""
    b, t, h, hd = q.shape
    rep = h // k.shape[2]

    def flat(x):
        return x.movedim(2, 1).reshape(b * h, t, hd)

    o = flash_attention_plain(flat(q), flat(k.repeat_interleave(rep, 2)),
                              flat(v.repeat_interleave(rep, 2)), causal)
    return o.reshape(b, h, t, hd).movedim(1, 2)


def _forward(q, k, v, causal):
    """(B, T, H, hd), (B, T, G, hd) x2 -> (B, T, H, hd): the kernel on
    CUDA tensors (it reads each query head's KV head in place), the plain
    version on CPU tensors."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return _gqa_plain(q, k, v, causal)
    _check_cuda(q, k, v)
    b, t, h, hd = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = []
    for x in (q, k, v, o):
        strides += [x.stride(0), x.stride(2), x.stride(1)]
    _launch(q, k, v, o, strides, b, h, k.shape[2], t, hd, causal)
    return o


def _backward(q, k, v, do, causal):
    """The reference's recompute backward (`_flash_bwd`) on the GQA
    layout: scores, softmax, then dv, dp, ds, dq and dk in f32, each cast
    to its input's dtype. dk and dv sum over the H / G query heads of
    each group, as the autodiff of the reference's repeat does."""
    b, t, h, hd = q.shape
    g = k.shape[2]
    scale = 1.0 / (hd ** 0.5)
    qf = q.to(torch.float32).reshape(b, t, g, h // g, hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dof = do.to(torch.float32).reshape(b, t, g, h // g, hd)
    s = torch.einsum("btgre,bsge->bgrts", qf, kf) * scale
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(t, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bgrts,btgre->bsge", p, dof)
    dp = torch.einsum("btgre,bsge->bgrts", dof, vf)
    ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True)) * scale
    dq = torch.einsum("bgrts,bsge->btgre", ds, kf).reshape(b, t, h, hd)
    dk = torch.einsum("bgrts,btgre->bsge", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Differentiable flash attention on (B, T, H, hd) / (B, T, G, hd):
    the forward is the kernel (the plain version on the CPU), the
    backward the reference's recompute. Under `torch.func.vmap` the
    `vmap` rule folds the vmapped dim into B, so the K clients of a
    vmapped local update share one launch, and `forward` always receives
    plain tensors, whose storage the ctypes launch can read."""

    generate_vmap_rule = False

    @staticmethod
    def forward(q, k, v, causal):
        # inside a training recompute, the backward's run reads the first
        # run's output back instead of launching again
        return recompute.saved(lambda: _forward(q, k, v, causal))

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*_backward(q, k, v, do, ctx.causal), None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal):
        n = info.batch_size

        def fold(x, dim):
            # (n, B, ...) -> (n * B, ...); an unbatched input is expanded
            x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            x = x.reshape(n * x.shape[1], *x.shape[2:])
            return x if x.device.type == "cpu" or _kernel_layout(x) \
                else x.contiguous()

        qf, kf, vf = (fold(x, d) for x, d in zip((q, k, v), in_dims))
        o = _Flash.apply(qf, kf, vf, causal)
        return o.reshape(n, o.shape[0] // n, *o.shape[1:]), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, blk_q: int = 128,
                    blk_k: int = 128) -> torch.Tensor:
    """q/k/v: (BH, T, d) (heads pre-flattened). Returns (BH, T, d) in
    q's dtype. T must divide by blk_q and blk_k (the reference's
    asserts)."""
    bh, t, d = q.shape
    if not k.shape == v.shape == (bh, t, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    assert t % blk_q == 0 and t % blk_k == 0
    o = _Flash.apply(q[:, :, None], k[:, :, None], v[:, :, None], causal)
    return o[:, :, 0]


flash_attention.launches = 0


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, blk_q: int = 128,
              blk_k: int = 128) -> torch.Tensor:
    """GQA wrapper: q (B,T,H,hd), k/v (B,T,G,hd) -> (B,T,H,hd)."""
    b, t, h, hd = q.shape
    g = k.shape[2]
    if not (k.shape == v.shape == (b, t, g, hd) and h % g == 0):
        raise ValueError(f"gqa_flash: want q (B,T,H,hd) and k, v (B,T,G,hd) "
                         f"with H % G == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    assert t % blk_q == 0 and t % blk_k == 0
    return _Flash.apply(q, k, v, causal)
