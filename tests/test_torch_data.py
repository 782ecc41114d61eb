"""The port's numpy data helpers against the JAX package's, bit for bit.

`repro_torch.data.synthetic` keeps its own copy of
`repro.data.synthetic`'s `dirichlet_partition`, `lm_token_batches` and
`batch_iterator`, and `repro_torch.core.server._epoch_batcher` is the
copy of `repro.core.server._epoch_batcher`. All are numpy on
`np.random.default_rng`, so at the same seeds they must give the same
arrays, with the same dtypes, and the iterators the same first yields.
The cases mirror tests/test_data.py's, then go over more seeds and
shapes.
"""
import numpy as np
import pytest

from repro.core import server as jserver
from repro.data import synthetic as jsyn
from repro_torch.core import server as tserver
from repro_torch.data import synthetic as tsyn


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.fixture(scope="module")
def task():
    return tsyn.make_image_task(seed=0, num_train=2000, num_test=10)


def _small_ds(n=10):
    return tsyn.Dataset(np.arange(4 * n, dtype=np.float32).reshape(n, 2, 2, 1),
                        np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("seed,num_nodes,alpha,samples", [
    (0, 5, 0.5, 200),  # tests/test_data.py's case
    (1, 3, 0.1, 50),   # near one-class nodes
    (7, 4, 100.0, 120),  # near IID
    (3, 2, 0.05, 2500),  # more samples than a class holds: with replacement
])
def test_dirichlet_partition_bit_for_bit(task, seed, num_nodes, alpha,
                                         samples):
    train, _ = task
    got = tsyn.dirichlet_partition(np.random.default_rng(seed), train,
                                   num_nodes, alpha, samples)
    want = jsyn.dirichlet_partition(np.random.default_rng(seed), train,
                                    num_nodes, alpha, samples)
    assert len(got) == len(want) == num_nodes
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g.y) == samples
        _same(g.x, w.x, f"node {i} x")
        _same(g.y, w.y, f"node {i} y")


def test_dirichlet_partition_leaves_the_generator_where_the_reference_does(
        task):
    train, _ = task
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    tsyn.dirichlet_partition(rt, train, 3, 0.5, 100)
    jsyn.dirichlet_partition(rj, train, 3, 0.5, 100)
    _same(rt.integers(0, 1 << 30, 8), rj.integers(0, 1 << 30, 8))


@pytest.mark.parametrize("seed,k,b,t,vocab,skew", [
    (0, 4, 8, 64, 100, True),  # tests/test_data.py's case
    (3, 3, 4, 65, 256, True),
    (11, 2, 2, 17, 32768, True),
    (0, 4, 8, 64, 100, False),
])
def test_lm_token_batches_bit_for_bit(seed, k, b, t, vocab, skew):
    got = tsyn.lm_token_batches(seed, k, b, t, vocab, skew=skew)
    want = jsyn.lm_token_batches(seed, k, b, t, vocab, skew=skew)
    _same(got, want)
    assert got.dtype == np.int32 and got.shape == (k, b, t)
    assert got.min() >= 0 and got.max() < vocab


def test_lm_tokens_noniid_skew():
    toks = tsyn.lm_token_batches(0, 4, 8, 64, 100)
    top = [np.bincount(toks[i].ravel(), minlength=100).argmax()
           for i in range(4)]
    assert len(set(top)) > 1


def test_lm_token_batches_zipf_exponent():
    _same(tsyn.lm_token_batches(2, 2, 3, 40, 500, zipf_a=2.0),
          jsyn.lm_token_batches(2, 2, 3, 40, 500, zipf_a=2.0))


@pytest.mark.parametrize("n,batch_size,seed", [(10, 3, 0), (10, 5, 1),
                                               (7, 7, 2), (13, 4, 9)])
def test_batch_iterator_first_yields_bit_for_bit(n, batch_size, seed):
    ds = _small_ds(n)
    got = tsyn.batch_iterator(ds, batch_size, seed)
    want = jsyn.batch_iterator(jsyn.Dataset(ds.x, ds.y), batch_size, seed)
    # three epochs' worth: the permutation is redrawn at each epoch's end
    for i in range(3 * (n // batch_size) + 1):
        (gx, gy), (wx, wy) = next(got), next(want)
        _same(gx, wx, f"yield {i} x")
        _same(gy, wy, f"yield {i} y")
        assert gx.shape == (batch_size, 2, 2, 1) and gy.shape == (batch_size,)


@pytest.mark.parametrize("n,batch_size,seed", [(10, 3, 0), (600, 50, 4),
                                               (7, 7, 2)])
def test_epoch_batcher_first_yields_bit_for_bit(n, batch_size, seed):
    ds = _small_ds(n)
    got = tserver._epoch_batcher(ds, batch_size, seed)
    want = jserver._epoch_batcher(jsyn.Dataset(ds.x, ds.y), batch_size, seed)
    tau = n // batch_size
    for i in range(3):
        (gx, gy), (wx, wy) = next(got), next(want)
        _same(gx, wx, f"epoch {i} x")
        _same(gy, wy, f"epoch {i} y")
        assert gx.shape == (tau, batch_size, 2, 2, 1)
        assert gy.shape == (tau, batch_size)


def test_epoch_batcher_rejects_batch_larger_than_dataset():
    ds = _small_ds(10)
    with pytest.raises(ValueError, match="tau"):
        next(tserver._epoch_batcher(ds, batch_size=50, seed=0))
