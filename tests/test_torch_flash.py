"""The port's flash attention against the JAX package's Pallas kernel, and
(on a card) the CUDA kernel against its plain version.

On the CPU the port's wrappers take the plain version; they are held to
`repro.kernels.flash_attn` run as tests/test_flash_attn.py runs it
(interpret mode), at that file's cases, on the same numpy inputs. bf16
inputs are made in f32 numpy and cast in each framework (both round to
nearest even, so both see the same bits). Tolerances are the
reference's own: 2e-5 for f32, 3e-2 for bf16.

The bf16 CUDA kernel (csrc/flash_mma.cuh) rounds where the reference
does not: it scales the f32 scores after the product, takes exp2 with
log2(e) folded into the scale, and rounds the probabilities to bf16 for
the P V product on the tensor cores. `_tensor_core_emulation` repeats
that rounding in plain torch, and is held to the Pallas kernel here, so
that the design's numerics are shown to fit the reference on the CPU.
The f32 kernel (csrc/flash_attn.cu) runs both products as 3xTF32 on the
tensor cores; `_tf32x3_emulation` repeats its arithmetic (the split of
every operand into two TF32 parts, three products per 8-deep mma step,
the permuted keys of P V, the online softmax over 32-key tiles) and is
held to the Pallas kernel at the f32 allowance, 2e-5.

`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash.py`
runs the card-only class (it imports no jax).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as tfa

# (BH, T, d, dtype, causal, blk_q, blk_k): tests/test_flash_attn.py's
CASES = [
    (4, 256, 64, "float32", True, 64, 64),
    (2, 256, 128, "float32", False, 128, 64),
    (2, 512, 64, "float32", True, 128, 128),
    (3, 128, 64, "bfloat16", True, 64, 32),
]


def _tol(dtype: str) -> float:
    return 2e-5 if dtype == "float32" else 3e-2


def _qkv(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("bh,t,d,dtype,causal,bq,bk", CASES)
def test_flash_matches_pallas(bh, t, d, dtype, causal, bq, bk):
    from repro.kernels import flash_attn as jfa

    q, k, v = _qkv([(bh, t, d)] * 3)
    want = jfa.flash_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                               causal, bq, bk)
    got = tfa.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), causal, bq, bk)
    assert got.dtype == getattr(torch, dtype) and got.shape == (bh, t, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_flash_matches_pallas(dtype):
    from repro.kernels import flash_attn as jfa

    b, t, h, g, hd = 2, 128, 4, 2, 64
    q, k, v = _qkv([(b, t, h, hd), (b, t, g, hd), (b, t, g, hd)], seed=3)
    want = jfa.gqa_flash(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                         blk_q=64, blk_k=64)
    got = tfa.gqa_flash(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                        blk_q=64, blk_k=64)
    assert got.shape == (b, t, h, hd)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _tensor_core_emulation(q, k, v, causal, blk_k=64):
    """The bf16 kernel's arithmetic on (BH, T, d) bf16 tensors: scores of
    the bf16 q and k in f32, times scale * log2(e) after the product;
    masked scores -1e30; an online softmax over `blk_k`-key tiles (the
    kernel's) in exp2; l summed from the f32 probabilities, which are
    then rounded to bf16 for P V (f32 sums); acc / max(l, 1e-30) in
    bf16."""
    bh, t, d = q.shape
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * (
        math.log2(math.e) / math.sqrt(d))
    if causal:
        keep = torch.arange(t)[None, :] <= torch.arange(t)[:, None]
        s = torch.where(keep, s, torch.full_like(s, tfa.NEG_INF))
    m = torch.full((bh, t), tfa.NEG_INF)
    l = torch.zeros((bh, t))
    acc = torch.zeros((bh, t, d))
    for k0 in range(0, t, blk_k):
        st = s[:, :, k0:k0 + blk_k]
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp2(st - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bts,bsd->btd", p.bfloat16().float(),
            v[:, k0:k0 + blk_k].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


# (BH, T, d, causal, blk_q, blk_k): the reference test's bf16 case, then
# the kernel's other head dims, 256 (gemma's) causal and not
EMULATION_CASES = [
    (3, 128, 64, True, 64, 32),
    (2, 128, 64, False, 64, 64),
    (2, 96, 128, True, 32, 32),
    (2, 64, 256, True, 32, 32),
    (2, 96, 256, False, 32, 32),
]


@pytest.mark.parametrize("bh,t,d,causal,bq,bk", EMULATION_CASES)
def test_tensor_core_rounding_matches_pallas(bh, t, d, causal, bq, bk):
    from repro.kernels import flash_attn as jfa

    q, k, v = _qkv([(bh, t, d)] * 3, seed=7)
    want = jfa.flash_attention(_jax(q, "bfloat16"), _jax(k, "bfloat16"),
                               _jax(v, "bfloat16"), causal, bq, bk)
    got = _tensor_core_emulation(_torch(q, "bfloat16"),
                                 _torch(k, "bfloat16"),
                                 _torch(v, "bfloat16"), causal)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, t, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def _tf32(x, rna=False):
    """The TF32 value the tensor core reads from f32 `x`: the top 19 bits
    (truncation), or `x` rounded to nearest, ties away (rna)."""
    bits = x.view(torch.int32)
    if rna:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _split(x):
    """The kernel's split: hi = x truncated to TF32, lo = x - hi (exact
    in f32), which the tensor core truncates to TF32 in turn."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(a, b, passes=3):
    """a @ b (f32, (.., M, K) @ (.., K, N)) as the kernel's mma.sync steps:
    8-deep steps into one f32 accumulator, each step lo_a hi_b, then
    hi_a lo_b, then hi_a hi_b (passes=3), or one TF32 product of the
    operands rounded to nearest (passes=1)."""
    if passes == 1:
        ah, bh = _tf32(a, True), _tf32(b, True)
    else:
        (ah, al), (bh, bl) = _split(a), _split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            acc = acc + al[..., ks] @ bh[..., ks, :]
            acc = acc + ah[..., ks] @ bl[..., ks, :]
        acc = acc + ah[..., ks] @ bh[..., ks, :]
    return acc


# mma k-slot t of a P V step holds key 2 t of its 8, slot t + 4 key 2 t + 1
_P_SLOTS = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _tf32x3_emulation(q, k, v, causal, passes=3, blk_k=32):
    """The f32 kernel's arithmetic on (BH, T, d) f32 tensors: q scaled in
    f32, S = q k^T in mma steps (at d = 256 as two halves of the head dim,
    added after), masked scores -1e30; an online softmax over `blk_k`-key
    tiles in exp2 with log2(e) folded in; O += P V in mma steps with the
    keys of each step in the kernel's slot order; acc / max(l, 1e-30)."""
    bh, t, d = q.shape
    l2e = math.log2(math.e)
    qs = q * (1.0 / math.sqrt(d))
    halves = 2 if d == 256 else 1
    w = d // halves
    s = _mma(qs[..., :w], k[..., :w].transpose(1, 2), passes)
    for i in range(1, halves):
        s = s + _mma(qs[..., i * w:(i + 1) * w],
                     k[..., i * w:(i + 1) * w].transpose(1, 2), passes)
    if causal:
        keep = torch.arange(t)[None, :] <= torch.arange(t)[:, None]
        s = torch.where(keep, s, torch.full_like(s, tfa.NEG_INF))
    m = torch.full((bh, t), tfa.NEG_INF)
    l = torch.zeros((bh, t))
    acc = torch.zeros((bh, t, d))
    for k0 in range(0, t, blk_k):
        st = s[:, :, k0:k0 + blk_k]
        vt = v[:, k0:k0 + blk_k]
        if st.shape[-1] % 8:  # a ragged last tile: zero keys, masked
            pad = 8 - st.shape[-1] % 8
            st = torch.cat([st, torch.full(st.shape[:-1] + (pad,),
                                           tfa.NEG_INF)], -1)
            vt = torch.cat([vt, torch.zeros((bh, pad, d))], 1)
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp2(st * l2e - (m_new * l2e)[..., None])
        corr = torch.exp2((m - m_new) * l2e)
        l = l * corr + p.sum(-1)
        order = torch.cat([g * 8 + _P_SLOTS
                           for g in range(st.shape[-1] // 8)])
        acc = acc * corr[..., None] + _mma(p[..., order], vt[:, order],
                                           passes)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def _attention_f64(q, k, v, causal):
    """Naive softmax attention in float64 (the exact function)."""
    q, k, v = q.double(), k.double(), v.double()
    t = q.shape[1]
    s = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
    if causal:
        keep = torch.arange(t)[None, :] <= torch.arange(t)[:, None]
        s = torch.where(keep, s, torch.full_like(s, tfa.NEG_INF))
    return torch.softmax(s, -1) @ v


# (BH, T, d, causal, blk_q, blk_k): the reference test's f32 cases, then
# hd = 256 (gemma's, where the kernel splits S's sum in two) causal and not
TF32X3_CASES = [c[:3] + c[4:] for c in CASES if c[3] == "float32"] + [
    (2, 64, 256, True, 32, 32),
    (2, 96, 256, False, 32, 32),
]


@pytest.mark.parametrize("bh,t,d,causal,bq,bk", TF32X3_CASES)
def test_tf32x3_arithmetic_matches_pallas(bh, t, d, causal, bq, bk):
    from repro.kernels import flash_attn as jfa

    q, k, v = _qkv([(bh, t, d)] * 3, seed=11)
    want = jfa.flash_attention(_jax(q, "float32"), _jax(k, "float32"),
                               _jax(v, "float32"), causal, bq, bk)
    got = _tf32x3_emulation(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_tf32_split_holds_f32_and_one_pass_does_not():
    # the split keeps x to 2^-20 in two TF32 values (low 13 bits zero) ...
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.normal(size=4096) * np.exp2(
        rng.integers(-30, 30, 4096))).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    rel = ((hi.double() + lo.double() - x.double()).abs() /
           x.double().abs()).max()
    assert rel <= 2.0 ** -20
    assert ((_tf32(x, True).double() - x.double()).abs() /
            x.double().abs()).max() > 2.0 ** -13  # one TF32 keeps ~2^-11
    # ... and one TF32 pass of both products misses the reference test's
    # f32 allowance, where three pass
    q, k, v = (torch.from_numpy(a) for a in _qkv([(2, 96, 256)] * 3,
                                                  seed=13))
    want = _attention_f64(q, k, v, causal=True)
    excess = {}
    for passes in (1, 3):
        got = _tf32x3_emulation(q, k, v, True, passes=passes).double()
        excess[passes] = float(((got - want).abs() /
                                (2e-5 + 2e-5 * want.abs())).max())
    assert excess[3] <= 1.0 < 4.0 < excess[1], excess


def test_plain_matches_reference_oracle_non_causal_bf16():
    from repro.kernels import ref

    q, k, v = _qkv([(2, 64, 64)] * 3, seed=5)
    want = ref.flash_attention(_jax(q, "bfloat16"), _jax(k, "bfloat16"),
                               _jax(v, "bfloat16"), causal=False)
    got = tfa.flash_attention_plain(_torch(q, "bfloat16"),
                                    _torch(k, "bfloat16"),
                                    _torch(v, "bfloat16"), causal=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_first_row_attends_only_self():
    q = torch.ones((1, 64, 64))
    k, v = (torch.from_numpy(a) for a in _qkv([(1, 64, 64)] * 2, seed=1))
    out = tfa.flash_attention(q, k, v, True, 32, 32)
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0].numpy(), rtol=1e-5)


def test_reference_asserts_are_kept():
    q = torch.zeros((1, 96, 64))
    with pytest.raises(AssertionError):
        tfa.flash_attention(q, q, q, True, 64, 64)  # 96 % 64 != 0
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q[:, :64], q, True, 32, 32)
    with pytest.raises(ValueError):  # H % G != 0
        tfa.gqa_flash(torch.zeros((1, 64, 3, 64)), q[:, :64, None].repeat(
            1, 1, 2, 1), q[:, :64, None].repeat(1, 1, 2, 1))


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv([(2, 64, 64)] * 3))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, True, 64, 64)
    assert tfa.flash_attention.launches == before
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v, True))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestFlashOnCard:
    """The CUDA kernel against its plain version on the card
    (chip_smoke.py runs the same comparison with timings)."""

    @pytest.mark.parametrize("bh,t,d,dtype,causal,bq,bk", CASES + [
        (2, 256, 256, "float32", True, 128, 128),
        (2, 256, 256, "bfloat16", False, 128, 128),
        # the tensor-core kernel: every head dim, causal and not, and T
        # not a multiple of its tiles (96; 40, not one of 16 mma rows)
        (2, 256, 64, "bfloat16", False, 64, 64),
        (2, 256, 128, "bfloat16", True, 128, 64),
        (2, 256, 128, "bfloat16", False, 64, 64),
        (2, 256, 256, "bfloat16", True, 64, 64),
        (3, 96, 64, "bfloat16", True, 32, 32),
        (2, 96, 256, "bfloat16", False, 32, 32),
        (2, 40, 128, "bfloat16", True, 8, 8),
        (2, 40, 256, "bfloat16", False, 8, 8),
        (2, 96, 256, "float32", True, 32, 32),
        # the 3xTF32 kernel: every head dim, causal and not, T = 96 and 40
        (2, 256, 64, "float32", False, 64, 64),
        (2, 256, 128, "float32", True, 128, 64),
        (2, 256, 256, "float32", False, 64, 64),
        (3, 96, 64, "float32", True, 32, 32),
        (2, 96, 128, "float32", False, 32, 32),
        (2, 40, 128, "float32", True, 8, 8),
        (2, 40, 256, "float32", False, 8, 8)])
    def test_flash_attention(self, cuda_device, bh, t, d, dtype, causal, bq,
                             bk):
        q, k, v = (_torch(a, dtype, cuda_device)
                   for a in _qkv([(bh, t, d)] * 3))
        before = tfa.flash_attention.launches
        got = tfa.flash_attention(q, k, v, causal, bq, bk)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == before + 1
        want = tfa.flash_attention_plain(q, k, v, causal)
        tol = _tol(dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)

    @pytest.mark.parametrize("h,g", [(8, 1), (4, 2), (4, 4)])
    def test_gqa_flash_reads_the_kv_head_in_place(self, cuda_device, h, g):
        b, t, hd = 2, 128, 128
        q, k, v = (_torch(a, "float32", cuda_device) for a in _qkv(
            [(b, t, h, hd), (b, t, g, hd), (b, t, g, hd)], seed=4))
        got = tfa.gqa_flash(q, k, v, blk_q=64, blk_k=64)
        kx = torch.repeat_interleave(k, h // g, dim=2)
        vx = torch.repeat_interleave(v, h // g, dim=2)
        want = tfa.gqa_flash(q.cpu(), kx.cpu(), vx.cpu(), blk_q=64,
                             blk_k=64)
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)

    def test_f32_at_gemma_prefill_shape(self, cuda_device):
        # gemma-2b's prefill: B = 4, T = 1024, H = 8 query heads on one KV
        # head, hd = 256, causal
        b, t, h, g, hd = 4, 1024, 8, 1, 256
        q, k, v = (_torch(a, "float32", cuda_device) for a in _qkv(
            [(b, t, h, hd), (b, t, g, hd), (b, t, g, hd)], seed=9))
        before = tfa.flash_attention.launches
        got = tfa.gqa_flash(q, k, v)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == before + 1
        kx = torch.repeat_interleave(k, h, dim=2)
        vx = torch.repeat_interleave(v, h, dim=2)

        def flat(x):
            return x.movedim(2, 1).reshape(b * h, t, hd)

        want = tfa.flash_attention_plain(flat(q), flat(kx), flat(vx), True)
        torch.testing.assert_close(
            got, want.reshape(b, h, t, hd).movedim(1, 2), atol=2e-5,
            rtol=2e-5)

    @pytest.mark.parametrize("h,g", [(8, 1), (4, 2), (4, 4)])
    def test_gqa_flash_bf16_on_the_tensor_cores(self, cuda_device, h, g):
        b, t, hd = 2, 192, 256
        q, k, v = (_torch(a, "bfloat16", cuda_device) for a in _qkv(
            [(b, t, h, hd), (b, t, g, hd), (b, t, g, hd)], seed=6))
        got = tfa.gqa_flash(q, k, v, blk_q=64, blk_k=64)
        want = tfa.gqa_flash(q.cpu(), k.cpu(), v.cpu(), blk_q=64, blk_k=64)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=3e-2, rtol=3e-2)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_strided_views_are_read_in_place(self, cuda_device, dtype):
        # q, k, v as slices of one fused (B, T, H + 2G, hd) projection:
        # rows (H + 2G) hd apart, no copy made
        b, t, h, g, hd = 2, 160, 4, 2, 128
        (qkv,) = _qkv([(b, t, h + 2 * g, hd)], seed=8)
        qkv = _torch(qkv, dtype, cuda_device)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + g], qkv[:, :, h + g:]
        assert not q.is_contiguous()
        got = tfa.gqa_flash(q, k, v, blk_q=32, blk_k=32)
        want = tfa.gqa_flash(q.cpu().contiguous(), k.cpu().contiguous(),
                             v.cpu().contiguous(), blk_q=32, blk_k=32)
        tol = _tol(dtype)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_each_dtype_launches_its_kernel(self, cuda_device, dtype):
        from torch.profiler import ProfilerActivity, profile

        dt = getattr(torch, dtype)
        q, k, v = (_torch(a, dtype, cuda_device) for a in _qkv(
            [(2, 128, 4, 256), (2, 128, 1, 256), (2, 128, 1, 256)]))
        assert tfa.KERNELS == {torch.bfloat16: "flash_mma_kernel",
                               torch.float32: "flash_tf32_kernel"}
        before = tfa.flash_attention.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tfa.gqa_flash(q, k, v, blk_q=64, blk_k=64)
            torch.cuda.synchronize()
        assert tfa.flash_attention.launches == before + 1
        names = [e.key for e in prof.key_averages()]
        other = [n for d, n in tfa.KERNELS.items() if d != dt]
        assert any(tfa.KERNELS[dt] in n for n in names), names
        assert not any(o in n for o in other for n in names), names

    def test_refuses_grad_and_unsupported_inputs(self, cuda_device):
        x = torch.zeros((1, 64, 64), device=cuda_device)
        with pytest.raises(TypeError):
            tfa.flash_attention(x.double(), x.double(), x.double(), True,
                                64, 64)
        y = torch.zeros((1, 64, 96), device=cuda_device)
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_attention(y, y, y, True, 64, 64)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_grads_through_the_kernel_equal_the_plain_version(
            self, cuda_device, dtype):
        # under vmap(grad) over 3 clients (k, v batched and shared) and
        # under grad alone, G < H: the kernel's forward, the recompute
        # backward, against autograd through the plain version on the card
        n, b, t, h, g, hd = 3, 2, 128, 4, 2, 64
        q, k, v = (_torch(a, dtype, cuda_device) for a in _qkv(
            [(n, b, t, h, hd), (n, b, t, g, hd), (n, b, t, g, hd)], seed=3))
        w = _torch(_qkv([(b, t, h, hd)], seed=5)[0], dtype, cuda_device)

        def f(q, k, v):
            o = tfa.gqa_flash(q, k, v, blk_q=64, blk_k=64)
            return torch.sum(o.float() * w.float())

        def f_plain(q, k, v):
            return torch.sum(tfa._gqa_plain(q, k, v, True).float()
                             * w.float())

        tol = _tol(dtype)
        for in_dims, args in (((0, 0, 0), (q, k, v)),
                              ((0, None, None), (q, k[0], v[0]))):
            before = tfa.flash_attention.launches
            got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)),
                                  in_dims=in_dims)(*args)
            torch.cuda.synchronize()
            assert tfa.flash_attention.launches == before + 1
            want = torch.func.vmap(torch.func.grad(f_plain,
                                                   argnums=(0, 1, 2)),
                                   in_dims=in_dims)(*args)
            for a, e in zip(got, want):
                torch.testing.assert_close(a.float(), e.float(), atol=tol,
                                           rtol=tol)
        got = torch.func.grad(f, argnums=(0, 1, 2))(q[0], k[0], v[0])
        want = torch.func.grad(f_plain, argnums=(0, 1, 2))(q[0], k[0], v[0])
        for a, e in zip(got, want):
            torch.testing.assert_close(a.float(), e.float(), atol=tol,
                                       rtol=tol)
