"""The port's optimizers (`repro_torch.optim.sgd`) against the JAX
package's (`repro.optim.sgd`).

Both packages start from the same numpy params (f32, or bf16 carried bit
for bit through `convert.params_from_numpy`) and take the same numpy
gradients for 3 updates at a fixed lr; the params, the f32 moment
buffers and adam's int32 step count must agree after every update at
1e-6 (rtol and atol), and the params keep their dtype. Then the paper's
lr schedule, `exponential_decay`.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import sgd as jopt
from repro_torch import convert
from repro_torch.optim import sgd as topt

TOL = dict(rtol=1e-6, atol=1e-6)
STEPS = 3
LR = 0.05


def _params(dtype, seed=0):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(8, 5)), "b": rng.normal(size=(5,)),
            "blk": {"scale": rng.normal(size=(3, 4, 2))}}
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    return jax.tree.map(lambda a: a.astype(np.float32).astype(dt), tree)


def _grads(step, seed=1):
    rng = np.random.default_rng(seed + 100 * step)
    return {"w": rng.normal(size=(8, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "blk": {"scale": rng.normal(size=(3, 4, 2)).astype(np.float32)}}


def _close(got, want, what):
    """A tree of tensors against a tree of jax arrays (dict leaves)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    w = np.asarray(want)
    g = convert.params_to_numpy({"x": got})["x"]
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(jopt.OPTIMIZERS))
def test_updates_match_jax(name, dtype):
    p0 = _params(dtype)
    jo, to = jopt.OPTIMIZERS[name](), topt.OPTIMIZERS[name]()
    jp = jax.tree.map(jnp.asarray, p0)
    tp = convert.params_from_numpy(p0, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(STEPS):
        g = _grads(step)
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js, LR)
        tp, ts = to.update(tp, convert.params_from_numpy(g, "cpu"), ts, LR)
        _close(tp, jp, f"{name} {dtype} step {step} params")
        if name == "momentum":
            _close(ts, js, f"momentum step {step} velocity")
        elif name == "adam":
            _close(ts["m"], js["m"], f"adam step {step} m")
            _close(ts["v"], js["v"], f"adam step {step} v")
            assert ts["t"].dtype == torch.int32
            assert int(ts["t"]) == int(js["t"]) == step + 1
        else:
            assert ts == js == ()


def test_state_is_f32_on_the_params_device():
    tp = convert.params_from_numpy(_params("bfloat16"), "cpu")
    vel = topt.momentum().init(tp)
    assert vel["w"].dtype == torch.float32 and vel["w"].shape == (8, 5)
    st = topt.adam().init(tp)
    assert st["m"]["blk"]["scale"].dtype == torch.float32
    assert st["t"].dtype == torch.int32 and st["t"].shape == ()
    assert int(st["t"]) == 0


def test_adam_hyperparameters_match_jax():
    p0, g = _params("float32"), _grads(0)
    jo = jopt.adam(b1=0.5, b2=0.9, eps=1e-3)
    to = topt.adam(b1=0.5, b2=0.9, eps=1e-3)
    jp, tp = jax.tree.map(jnp.asarray, p0), convert.params_from_numpy(
        p0, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(STEPS):
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js, 0.1)
        tp, ts = to.update(tp, convert.params_from_numpy(g, "cpu"), ts, 0.1)
    _close(tp, jp, "adam(b1=0.5, b2=0.9, eps=1e-3)")


@pytest.mark.parametrize("base_lr,rate", [(0.05, 0.995), (0.1, 0.5),
                                          (0.01, 1.0)])
def test_exponential_decay_matches_jax(base_lr, rate):
    js = jopt.exponential_decay(base_lr, rate)
    ts = topt.exponential_decay(base_lr, rate)
    for r in (0, 1, 7, 100, 1000):
        got, want = ts(r), np.asarray(js(r))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), **TOL)
    got = ts(torch.tensor(3, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(js(jnp.int32(3))), **TOL)
