"""The port's weighted_agg / round_stats against the JAX package's Pallas
kernels, and (on a card) the CUDA kernels against their plain versions.

On the CPU the port's wrappers take the plain versions; they are held to
the JAX kernels run as tests/test_kernels.py runs them (interpret mode,
min_kernel_elems=0 so the Pallas path is forced), on the same numpy
inputs: K across the reference's client-chunk edge (1, 3, 33), ragged N
around its 128x128 block (100, 16385, 33000) and the segment mask.

The JAX package is imported inside the parity tests only, so the
`cuda`-marked class also runs on a GPU machine that has no jax:
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py`.

Tolerances (f32 sums taken in different orders):
  * aggregate: |dy_n| <= 1e-5 * sum_k |w_k x_kn| (+1e-30);
  * dots: |d dot_k| <= 1e-5 * sum_n |x_kn g_n| (a dot of random rows is
    a cancelling sum, so a bound relative to the dot itself is not
    meaningful);
  * squared norms (sums of non-negative terms): 1e-5 relative.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import round_stats as trs
from repro_torch.kernels import weighted_agg as twa

TOL = 1e-5


def _inputs(k, n, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, n)).astype(np.float32)
    g = rng.normal(size=(n,)).astype(np.float32)
    w = rng.uniform(size=(k,)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones(n, np.float32)
        mask[n // 3: n // 3 + max(1, n // 4)] = 0.0  # a dropped segment
        mask[rng.uniform(size=n) < 0.1] = 0.0
    return x, g, w, mask


def assert_agg_close(got, want, w, x, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(np.asarray(w, np.float64))[:, None] * np.abs(
        np.asarray(x, np.float64))
    bound = tol * scale.sum(0) + 1e-30
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= bound), np.max(
        np.abs(got - want) / bound)


def assert_stats_close(got, want, x, g, mask, tol=TOL):
    x = np.asarray(x, np.float64)
    g = np.asarray(g, np.float64)
    if mask is not None:
        m = np.asarray(mask, np.float64)
        x, g = x * m[None], g * m
    dots, sqs, sqg = (np.asarray(t, np.float64) for t in got)
    wd, ws, wg = (np.asarray(t, np.float64) for t in want)
    dot_bound = tol * (np.abs(x) * np.abs(g)[None]).sum(1) + 1e-30
    assert np.all(np.abs(dots - wd) <= dot_bound), "dots"
    np.testing.assert_allclose(sqs, ws, rtol=tol, err_msg="sqs")
    np.testing.assert_allclose(sqg, wg, rtol=tol, err_msg="sqg")


@pytest.mark.parametrize("k", [1, 3, 33])
@pytest.mark.parametrize("n", [100, 16385, 33000])
def test_weighted_agg_matches_pallas(k, n):
    import jax.numpy as jnp
    from repro.kernels import weighted_agg as jwa

    x, _, w, _ = _inputs(k, n)
    want = jwa.weighted_agg(jnp.asarray(w), jnp.asarray(x),
                            min_kernel_elems=0, out_dtype=jnp.float32)
    got = twa.weighted_agg(torch.from_numpy(w), torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_agg_close(got.numpy(), want, w, x)


def _round_stats_against_pallas(k, n, masked, x_dtype):
    """The port's round_stats and the JAX package's (interpret mode, the
    Pallas path forced) on the same inputs, x cast to x_dtype in each
    framework (round to nearest even in both, so the same bits)."""
    import jax.numpy as jnp
    from repro.kernels import round_stats as jrs

    x, g, _, mask = _inputs(k, n, masked=masked)
    want = jrs.round_stats(jnp.asarray(x).astype(getattr(jnp, x_dtype)),
                           jnp.asarray(g),
                           None if mask is None else jnp.asarray(mask),
                           min_kernel_elems=0)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    got = trs.round_stats(tx, torch.from_numpy(g),
                          None if mask is None else torch.from_numpy(mask))
    assert [tuple(t.shape) for t in got] == [(k,), (k,), ()]
    assert_stats_close([t.numpy() for t in got], want, tx.float().numpy(),
                       g, mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 3, 33])
@pytest.mark.parametrize("n", [100, 16385, 33000])
def test_round_stats_matches_pallas(k, n, masked):
    _round_stats_against_pallas(k, n, masked, "float32")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 3, 33])
@pytest.mark.parametrize("n", [100, 16385, 33000])
def test_round_stats_bf16_matches_pallas(k, n, masked):
    """The same with x in bf16 (the bf16 uplink), sums in f32."""
    _round_stats_against_pallas(k, n, masked, "bfloat16")


def test_mask_restricts_to_the_subspace():
    """Masked stats are the stats of the masked vectors, not a rescale."""
    x, g, _, mask = _inputs(3, 16385, masked=True)
    tx, tg, tm = (torch.from_numpy(a) for a in (x, g, mask))
    masked = trs.round_stats(tx, tg, tm)
    direct = trs.round_stats(tx * tm, tg * tm)
    full = trs.round_stats(tx, tg)
    for a, b in zip(masked, direct):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    assert not np.allclose(masked[1].numpy(), full[1].numpy())


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    x, g, w, mask = _inputs(3, 1000, masked=True)
    before = (twa.weighted_agg.launches, trs.round_stats.launches)
    y = twa.weighted_agg(torch.from_numpy(w), torch.from_numpy(x))
    stats = trs.round_stats(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(mask))
    assert (twa.weighted_agg.launches, trs.round_stats.launches) == before
    np.testing.assert_array_equal(
        y.numpy(), twa.weighted_agg_plain(torch.from_numpy(w),
                                          torch.from_numpy(x)).numpy())
    for a, b in zip(stats, trs.round_stats_plain(
            torch.from_numpy(x), torch.from_numpy(g),
            torch.from_numpy(mask))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_out_dtype_casts_the_f32_sum():
    x, _, w, _ = _inputs(2, 64)
    y = twa.weighted_agg(torch.from_numpy(w), torch.from_numpy(x),
                         out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16


def test_plain_round_stats_accumulates_bf16_in_f32():
    """2^14 bf16 ones: a bf16 accumulator would saturate at 256."""
    n = 1 << 14
    x = torch.ones((2, n), dtype=torch.bfloat16)
    g = torch.ones(n, dtype=torch.bfloat16)
    dots, sqs, sqg = trs.round_stats(x, g)
    assert float(sqg) == float(n)
    assert dots.tolist() == [n, n] and sqs.tolist() == [n, n]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    """The CUDA kernels against their plain versions on the card, at the
    main path's shape and the edge shapes (chip_smoke.py runs the same
    comparison with timings)."""

    SHAPES = [(10, 1_663_370), (1, 7850), (3, 16385), (37, 1_000_003),
              (128, 7850), (4, 4099)]

    @pytest.mark.parametrize("k,n", SHAPES)
    def test_weighted_agg(self, cuda_device, k, n):
        x, _, w, _ = _inputs(k, n)
        tx = torch.from_numpy(x).to(cuda_device)
        tw = torch.from_numpy(w).to(cuda_device)
        before = twa.weighted_agg.launches
        got = twa.weighted_agg(tw, tx)
        torch.cuda.synchronize()
        assert twa.weighted_agg.launches == before + 1
        assert_agg_close(got.cpu().numpy(),
                         twa.weighted_agg_plain(tw, tx).cpu().numpy(), w, x)

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("k,n", SHAPES)
    def test_round_stats(self, cuda_device, k, n, masked):
        x, g, _, mask = _inputs(k, n, masked=masked)
        dev = [torch.from_numpy(a).to(cuda_device) if a is not None
               else None for a in (x, g, mask)]
        before = trs.round_stats.launches
        got = trs.round_stats(*dev)
        torch.cuda.synchronize()
        assert trs.round_stats.launches == before + 1
        want = trs.round_stats_plain(*dev)
        assert_stats_close([t.cpu().numpy() for t in got],
                           [t.cpu().numpy() for t in want], x, g, mask)
        again = trs.round_stats(*dev)  # no atomics: same bits every run
        for a, b in zip(got, again):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("offset", [0, 4, 8, 12])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("k,n", [(10, 1_663_370), (3, 16385), (4, 13),
                                     (37, 7850)])
    def test_round_stats_bf16(self, cuda_device, k, n, masked, offset):
        """bf16 x whose storage starts `offset` bytes past a 16-byte
        boundary (and rows at every even offset along the way)."""
        x, g, _, mask = _inputs(k, n, masked=masked)
        flat = torch.zeros(k * n + 8, dtype=torch.bfloat16,
                           device=cuda_device)
        xb = flat[offset // 2: offset // 2 + k * n].view(k, n)
        xb.copy_(torch.from_numpy(x).to(cuda_device).to(torch.bfloat16))
        assert xb.data_ptr() % 16 == offset
        dev = [xb] + [torch.from_numpy(a).to(cuda_device) if a is not None
                      else None for a in (g, mask)]
        before = trs.round_stats.launches
        got = trs.round_stats(*dev)
        torch.cuda.synchronize()
        assert trs.round_stats.launches == before + 1
        want = trs.round_stats_plain(*dev)
        assert_stats_close([t.cpu().numpy() for t in got],
                           [t.cpu().numpy() for t in want],
                           xb.float().cpu().numpy(), g, mask)
        again = trs.round_stats(*dev)  # no atomics: same bits every run
        for a, b in zip(got, again):
            assert torch.equal(a, b)

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, cuda_device):
        x = torch.zeros((3, 64), device=cuda_device)
        w = torch.ones(3, device=cuda_device)
        with pytest.raises(TypeError):
            twa.weighted_agg(w, x.double())
        with pytest.raises(ValueError):
            twa.weighted_agg(w, x.t().contiguous().t())
        with pytest.raises(ValueError):
            trs.round_stats(x, torch.zeros(63, device=cuda_device))
