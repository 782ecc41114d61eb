"""The port's flash attention against the JAX package's Pallas kernel, and
(on a card) the CUDA kernel against its plain version.

On the CPU the port's wrappers take the plain version; they are held to
`repro.kernels.flash_attn` run as tests/test_flash_attn.py runs it
(interpret mode), at that file's cases, on the same numpy inputs. bf16
inputs are made in f32 numpy and cast in each framework (both round to
nearest even, so both see the same bits). Tolerances are the
reference's own: 2e-5 for f32, 3e-2 for bf16.

`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash.py`
runs the card-only class (it imports no jax).
"""
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
        (2, 256, 256, "bfloat16", False, 128, 128)])
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
