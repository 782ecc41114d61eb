"""The port's batched_dot, grad_dot_stats and kernels/ops.py against the
JAX package's Pallas kernels, and (on a card) the CUDA kernels against
their plain versions.

On the CPU the port's wrappers take the plain versions; they are held to
the JAX kernels run as tests/test_kernels.py runs them (interpret mode,
`min_kernel_elems=0` so batched_dot takes the Pallas path), at that
file's shapes, on the same numpy inputs (bf16 made in f32 numpy and cast
in each framework). Tolerance: |d| <= 1e-5 * sum of |terms| (f32 sums
taken in different orders; a dot of random vectors cancels, so a bound
relative to the dot itself would not be meaningful).

`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ops.py`
runs the card-only class (it imports no jax).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grad_dot as tgd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import weighted_agg as twa

TOL = 1e-5
SHAPES = [(7,), (128,), (65536,), (1000, 333), (3, 17, 129)]
DTYPES = ["float32", "bfloat16"]


def _normal(seed, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=getattr(torch, dtype))


def _as64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float64)


def assert_sums_close(got, want, terms, tol=TOL):
    """Each got/want pair within tol * (its sum of |terms|)."""
    for g, w, s in zip(got, want, terms):
        g, w = _as64(g), _as64(w)
        assert g.shape == w.shape
        assert np.all(np.abs(g - w) <= tol * np.asarray(s) + 1e-30), (g, w)


def _rounded(a, dtype) -> np.ndarray:
    """a as the kernels see it: rounded to dtype, in float64."""
    return _as64(_torch(a, dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grad_dot_stats_matches_pallas(shape, dtype):
    from repro.kernels import grad_dot as jgd

    a, b = _normal(0, shape), _normal(1, shape)
    want = jgd.grad_dot_stats(_jax(a, dtype), _jax(b, dtype))
    got = tgd.grad_dot_stats(_torch(a, dtype), _torch(b, dtype))
    assert all(t.dtype == torch.float32 and t.shape == () for t in got)
    ar, br = _rounded(a, dtype), _rounded(b, dtype)
    assert_sums_close(got, want, [np.abs(ar * br).sum(), (ar * ar).sum(),
                                  (br * br).sum()])


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("n", [128, 16385, 50000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_dot_matches_pallas(k, n, dtype):
    from repro.kernels import weighted_agg as jwa

    x, g = _normal(0, (k, n)), _normal(1, (n,))
    want = jwa.batched_dot(_jax(x, dtype), _jax(g, dtype),
                           min_kernel_elems=0)
    got = twa.batched_dot(_torch(x, dtype), _torch(g, dtype))
    assert got.dtype == torch.float32
    xr, gr = _rounded(x, dtype), _rounded(g, dtype)
    assert_sums_close([got], [want], [np.abs(xr * gr[None]).sum(1)])


@pytest.mark.parametrize("k", [1, 33, 64])
def test_batched_dot_across_the_client_chunks(k):
    from repro.kernels import weighted_agg as jwa

    x, g = _normal(2, (k, 16385)), _normal(3, (16385,))
    want = jwa.batched_dot(_jax(x, "float32"), _jax(g, "float32"),
                           min_kernel_elems=0)
    got = twa.batched_dot(torch.from_numpy(x), torch.from_numpy(g))
    assert_sums_close([got], [want], [np.abs(_as64(x) * _as64(g)).sum(1)])


def _tree(seed):
    return {"a": _normal(seed, (257, 33)),
            "b": {"c": _normal(seed + 100, (1000,)),
                  "d": _normal(seed + 200, (4, 4, 4))}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stacked(seeds):
    trees = [_tree(s) for s in seeds]
    return {"a": np.stack([t["a"] for t in trees]),
            "b": {"c": np.stack([t["b"]["c"] for t in trees]),
                  "d": np.stack([t["b"]["d"] for t in trees])}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_ops_tree_dot_and_norms_matches_jax_ops():
    from repro.kernels import ops as jops

    a, b = _tree(0), _tree(1)
    want = jops.tree_dot_and_norms(_map(lambda x: _jax(x, "float32"), a),
                                   _map(lambda x: _jax(x, "float32"), b))
    got = tops.tree_dot_and_norms(_map(torch.from_numpy, a),
                                  _map(torch.from_numpy, b))
    fa = np.concatenate([x.ravel() for x in _leaves(a)]).astype(np.float64)
    fb = np.concatenate([x.ravel() for x in _leaves(b)]).astype(np.float64)
    assert_sums_close(got, want, [np.abs(fa * fb).sum(), (fa * fa).sum(),
                                  (fb * fb).sum()])


def test_ops_tree_weighted_sum_matches_jax_ops():
    from repro.kernels import ops as jops

    trees = _stacked(range(4))
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    want = jops.tree_weighted_sum(_map(lambda x: _jax(x, "float32"), trees),
                                  _jax(w, "float32"))
    got = tops.tree_weighted_sum(_map(torch.from_numpy, trees),
                                 torch.from_numpy(w))
    for g, ww, x in zip(_leaves(got), _leaves(_map(np.asarray, want)),
                        _leaves(trees)):
        scale = np.tensordot(np.abs(w), np.abs(x), axes=1)
        assert_sums_close([g], [ww], [scale])


def test_ops_tree_vdot_batched_matches_jax_ops():
    from repro.kernels import ops as jops

    trees, single = _stacked(range(3)), _tree(9)
    want = jops.tree_vdot_batched(_map(lambda x: _jax(x, "float32"), trees),
                                  _map(lambda x: _jax(x, "float32"), single))
    got = tops.tree_vdot_batched(_map(torch.from_numpy, trees),
                                 _map(torch.from_numpy, single))
    terms = sum(np.abs(x.reshape(3, -1).astype(np.float64)
                       * g.reshape(-1)[None]).sum(1)
                for x, g in zip(_leaves(trees), _leaves(single)))
    assert_sums_close([got], [want], [terms])


def test_batched_dot_reads_strided_rows_on_the_cpu_too():
    x = torch.from_numpy(_normal(4, (5, 300)))
    g = torch.from_numpy(_normal(5, (100,)))
    view = x[:, 37:137]
    assert not view.is_contiguous()
    torch.testing.assert_close(twa.batched_dot(view, g),
                               twa.batched_dot(view.contiguous(), g))


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    a, b = (torch.from_numpy(_normal(s, (3, 50))) for s in (0, 1))
    before = (twa.batched_dot.launches, tgd.grad_dot_stats.launches)
    twa.batched_dot(a, b[0])
    tgd.grad_dot_stats(a, b)
    assert (twa.batched_dot.launches, tgd.grad_dot_stats.launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOpsKernelsOnCard:
    """batched_dot and grad_dot_stats against their plain versions on
    the card (chip_smoke.py runs the same comparison with timings)."""

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("k,n", [(10, 1_663_370), (1, 7850),
                                     (37, 1_000_003), (3, 5)])
    def test_batched_dot(self, cuda_device, k, n, dtype):
        x = _torch(_normal(0, (k, n + 3)), dtype, cuda_device)[:, 3:]
        g = _torch(_normal(1, (n,)), dtype, cuda_device)
        before = twa.batched_dot.launches
        got = twa.batched_dot(x, g)
        torch.cuda.synchronize()
        assert twa.batched_dot.launches == before + 1
        xr, gr = _as64(x), _as64(g)
        assert_sums_close([got], [twa.batched_dot_plain(x, g)],
                          [np.abs(xr * gr[None]).sum(1)])
        assert torch.equal(got, twa.batched_dot(x, g))  # no atomics

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("shape", SHAPES + [(1_663_370,)])
    def test_grad_dot_stats(self, cuda_device, shape, dtype):
        a = _torch(_normal(0, shape), dtype, cuda_device)
        b = _torch(_normal(1, shape), dtype, cuda_device)
        before = tgd.grad_dot_stats.launches
        got = tgd.grad_dot_stats(a, b)
        torch.cuda.synchronize()
        assert tgd.grad_dot_stats.launches == before + 1
        ar, br = _as64(a), _as64(b)
        assert_sums_close(got, tgd.grad_dot_stats_plain(a, b),
                          [np.abs(ar * br).sum(), (ar * ar).sum(),
                           (br * br).sum()])

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("oa,ob", [(0, 0), (8, 0), (0, 8), (8, 8)])
    @pytest.mark.parametrize("n", [10, 2048, 2049, 1_663_370])
    def test_grad_dot_stats_at_offsets(self, cuda_device, n, oa, ob, dtype):
        """a and b whose storage starts oa / ob bytes past a 16-byte
        boundary (an odd client's row of the round's f32 buffer starts 8
        bytes past one), on one block (n <= 2,048) and on several."""
        def placed(seed, offset):
            z = _torch(_normal(seed, (n + 8,)), dtype, cuda_device)
            v = z[offset // z.element_size():][:n]
            assert v.data_ptr() % 16 == offset
            return v

        a, b = placed(0, oa), placed(1, ob)
        before = tgd.grad_dot_stats.launches
        got = tgd.grad_dot_stats(a, b)
        torch.cuda.synchronize()
        assert tgd.grad_dot_stats.launches == before + 1
        ar, br = _as64(a), _as64(b)
        assert_sums_close(got, tgd.grad_dot_stats_plain(a, b),
                          [np.abs(ar * br).sum(), (ar * ar).sum(),
                           (br * br).sum()])
        again = tgd.grad_dot_stats(a, b)  # no atomics: same bits every run
        assert all(torch.equal(x, y) for x, y in zip(got, again))
