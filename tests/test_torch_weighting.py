"""repro_torch.core.weighting against repro.core.weighting, to 1e-6.

Same numpy inputs into both; every ported function, including the
clip edges of the cosine, zero norms and the Eq. 9 scatter over a
partial selection. 1e-6 is the ROADMAP's pin for this O(K) scalar math
(f32 transcendental functions may differ by an ulp between XLA and
torch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weighting as jw
from repro_torch.core import weighting as tw

TOL = 1e-6


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=TOL,
                               atol=TOL)


def _stats(k=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, 50)).astype(np.float32)
    g = rng.normal(size=(50,)).astype(np.float32)
    a[0] = g  # cos = 1: the upper clip
    a[1] = -g  # cos = -1: the lower clip
    a[2] = 0.0  # a zero norm
    return (a @ g, np.sum(a * a, axis=1), np.float32(np.dot(g, g)))


def test_cosine_and_angle():
    dot, sq, sqg = _stats()
    j = [jnp.asarray(v) for v in (dot, sq, sqg)]
    t = [torch.as_tensor(v) for v in (dot, sq, sqg)]
    _close(jw.cosine_from_stats(*j), tw.cosine_from_stats(*t).numpy())
    _close(jw.instantaneous_angle(*j), tw.instantaneous_angle(*t).numpy())
    cos = tw.cosine_from_stats(*t)
    assert float(cos.max()) < 1.0 and float(cos.min()) > -1.0


@pytest.mark.parametrize("alpha", [1.0, 5.0, 10.0])
def test_gompertz_and_weights(alpha):
    rng = np.random.default_rng(1)
    theta = rng.uniform(0.0, np.pi, size=12).astype(np.float32)
    sizes = rng.integers(10, 600, size=12).astype(np.float32)
    _close(jw.gompertz(jnp.asarray(theta), alpha),
           tw.gompertz(torch.from_numpy(theta), alpha).numpy())
    wj = jw.fedadp_weights(jnp.asarray(theta), jnp.asarray(sizes), alpha)
    wt = tw.fedadp_weights(torch.from_numpy(theta), torch.from_numpy(sizes),
                           alpha)
    _close(wj, wt.numpy())
    assert abs(float(wt.sum()) - 1.0) < 1e-6
    _close(jw.fedavg_weights(jnp.asarray(sizes)),
           tw.fedavg_weights(torch.from_numpy(sizes)).numpy())
    cos = np.cos(theta)
    _close(jw.expected_contribution(wj, jnp.asarray(cos)),
           tw.expected_contribution(wt, torch.from_numpy(cos)).numpy())


def test_update_smoothed_angle_partial_selection():
    rng = np.random.default_rng(2)
    n = 10
    smoothed = rng.uniform(0, 1.5, size=n).astype(np.float32)
    count = rng.integers(0, 5, size=n).astype(np.int32)
    count[3] = 0  # a first participation: t = 1
    theta = rng.uniform(0, 1.5, size=n).astype(np.float32)
    sel = rng.uniform(size=n) < 0.5
    sel[3] = True
    js = jw.update_smoothed_angle(
        jw.AngleState(jnp.asarray(smoothed), jnp.asarray(count)),
        jnp.asarray(theta), jnp.asarray(sel))
    ts = tw.update_smoothed_angle(
        tw.AngleState(torch.from_numpy(smoothed), torch.from_numpy(count)),
        torch.from_numpy(theta), torch.from_numpy(sel))
    _close(js.smoothed, ts.smoothed.numpy())
    assert np.asarray(js.count).tolist() == ts.count.tolist()
    assert ts.count.dtype == torch.int32


def test_angle_state_init():
    s = tw.AngleState.init(7)
    j = jw.AngleState.init(7)
    assert s.smoothed.dtype == torch.float32 and s.count.dtype == torch.int32
    assert s.smoothed.tolist() == np.asarray(j.smoothed).tolist()
    assert s.count.tolist() == np.asarray(j.count).tolist()
    assert tw.DEFAULT_ALPHA == jw.DEFAULT_ALPHA
