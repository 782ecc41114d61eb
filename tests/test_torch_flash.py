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
        (2, 96, 256, "float32", True, 32, 32)])
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
        q = torch.zeros((1, 64, 64), device=cuda_device, requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            tfa.flash_attention(q, q, q, True, 64, 64)
        x = torch.zeros((1, 64, 64), device=cuda_device)
        with pytest.raises(TypeError):
            tfa.flash_attention(x.double(), x.double(), x.double(), True,
                                64, 64)
        y = torch.zeros((1, 64, 96), device=cuda_device)
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_attention(y, y, y, True, 64, 64)
