"""The port's models, data and tree math against the JAX package.

* `repro_torch.data.synthetic` is a numpy copy: its arrays must be
  IDENTICAL to the reference's for the same seeds.
* MLR and CNN logits, loss and gradients through `convert` (the same
  numpy weights in both packages), the CNN at batch 4. Tolerance: 1e-5
  relative to each tensor's largest entry (f32 convs and matmuls summed
  in different orders by XLA and by torch's CPU kernels).
* Flatten order: the port's ravel of the CNN's params is the reference's
  element for element (sorted keys b1, b2, c1, c2, f1, f2, fb1, fb2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import treemath as jtm
from repro.data import synthetic as jsyn
from repro.models import small as jsmall
from repro_torch import convert
from repro_torch.core import treemath as ttm
from repro_torch.data import synthetic as tsyn
from repro_torch.models import small as tsmall


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)


def test_synthetic_arrays_identical():
    jt, jv = jsyn.make_image_task(seed=3, num_train=500, num_test=50)
    tt, tv = tsyn.make_image_task(seed=3, num_train=500, num_test=50)
    for a, b in ((jt, tt), (jv, tv)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    spec = [("iid", None)] * 2 + [("xclass", 1), ("xclass", 3)]
    jn = jsyn.make_federated(jt, spec, samples_per_node=60, seed=1)
    tn = tsyn.make_federated(tt, spec, samples_per_node=60, seed=1)
    for a, b in zip(jn, tn):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    with pytest.raises(ValueError):
        tsyn.make_federated(tt, [("dirichlet", 1)])


def _model_inputs(model, seed=0):
    train, _ = jsyn.make_image_task(seed=seed, num_train=64, num_test=8)
    params = jax.tree.map(np.asarray,
                          jsmall.MODELS[model][0](jax.random.key(seed)))
    return params, train.x[:4], train.y[:4]


@pytest.mark.parametrize("model", ["mlr", "cnn"])
def test_logits_loss_and_grads_match(model):
    params, x, y = _model_inputs(model)
    japply, tapply = jsmall.MODELS[model][1], tsmall.MODELS[model][1]
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = convert.params_from_numpy(params, "cpu")
    assert _max_rel(japply(jparams, x),
                    tapply(tparams, torch.from_numpy(x)).numpy()) < 1e-5
    jl, jg = jax.value_and_grad(
        lambda p: jsmall.classification_loss(japply, p, x, y))(jparams)
    tg, tl = torch.func.grad_and_value(
        lambda p: tsmall.classification_loss(
            tapply, p, torch.from_numpy(x), torch.from_numpy(y)))(tparams)
    assert abs(float(jl) - float(tl)) < 1e-5 * abs(float(jl))
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert tg[k].shape == jg[k].shape, k
        assert _max_rel(jg[k], tg[k].numpy()) < 1e-5, k
    assert (tsmall.accuracy(tapply, tparams, x, y)
            == jsmall.accuracy(japply, jparams, x, y))


def test_cnn_param_count_and_layout():
    params = tsmall.cnn_init(torch.Generator().manual_seed(0))
    ref = jsmall.cnn_init(jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert sum(v.numel() for v in params.values()) == 1_663_370


def test_flatten_order_matches_jax():
    params, _, _ = _model_inputs("cnn")
    jvec, _ = jtm.tree_ravel(jax.tree.map(jnp.asarray, params))
    tvec, unravel = ttm.tree_ravel(convert.params_from_numpy(params, "cpu"))
    np.testing.assert_array_equal(np.asarray(jvec), tvec.numpy())
    assert ttm.tree_paths(params) == [(k,) for k in sorted(params)]
    back = unravel(tvec)
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), params[k])


def test_ravel_stacked_and_segment_mask_match_jax():
    rng = np.random.default_rng(0)
    stacked = {"z": rng.normal(size=(3, 2, 5)).astype(np.float32),
               "a": {"q": rng.normal(size=(3, 4)).astype(np.float32),
                     "b": rng.normal(size=(3,)).astype(np.float32)}}
    jbuf, _ = jtm.tree_ravel_stacked(jax.tree.map(jnp.asarray, stacked))
    tbuf, unravel = ttm.tree_ravel_stacked(
        convert.params_from_numpy(stacked, "cpu"))
    assert tbuf.is_contiguous() and tbuf.shape == (3, 2 * 5 + 4 + 1)
    np.testing.assert_array_equal(np.asarray(jbuf), tbuf.numpy())
    row = unravel(tbuf[1])
    np.testing.assert_array_equal(row["a"]["q"].numpy(), stacked["a"]["q"][1])
    single = jax.tree.map(lambda a: a[0], stacked)
    keep = [True, False, True]
    np.testing.assert_array_equal(
        np.asarray(jtm.segment_mask(jax.tree.map(jnp.asarray, single), keep)),
        ttm.segment_mask(convert.params_from_numpy(single, "cpu"),
                         keep).numpy())


def test_tree_reductions_match_jax():
    rng = np.random.default_rng(1)
    stacked = {"w": rng.normal(size=(4, 3, 2)).astype(np.float32),
               "b": rng.normal(size=(4, 5)).astype(np.float32)}
    single = jax.tree.map(lambda a: a[0] * 0.5, stacked)
    w = rng.uniform(size=4).astype(np.float32)
    js, jsg = (jax.tree.map(jnp.asarray, t) for t in (stacked, single))
    ts, tsg = (convert.params_from_numpy(t, "cpu") for t in (stacked, single))
    tws = ttm.tree_weighted_sum(ts, torch.from_numpy(w))
    jws = jtm.tree_weighted_sum(js, jnp.asarray(w))
    for k in stacked:
        np.testing.assert_allclose(tws[k].numpy(), np.asarray(jws[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ttm.tree_vdot_batched(ts, tsg).numpy(),
                               np.asarray(jtm.tree_vdot_batched(js, jsg)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ttm.tree_sqnorm_batched(ts).numpy(),
                               np.asarray(jtm.tree_sqnorm_batched(js)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ttm.tree_sqnorm(tsg)),
                               float(jtm.tree_sqnorm(jsg)), rtol=1e-6)
    axpy = ttm.tree_axpy(-0.5, tsg, ttm.tree_sub(tsg, tsg))
    np.testing.assert_allclose(axpy["w"].numpy(), -0.5 * single["w"],
                               rtol=1e-6)
