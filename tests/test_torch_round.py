"""The port's round (repro_torch.core.fl) against the JAX package's
engine="flat" round, on the same injected inputs.

Both packages start from the same numpy params, angle state and round
index, and are fed the same batches, `sel_idx` and `data_sizes` every
round, so the comparison needs no shared RNG. The port runs both of its
engines: "flat" (on the CPU the kernels' plain versions) and "tree" (plain
per-leaf torch). Checked after every round: params, the Eq. 9 angle state
and every metrics key.

Problems: the toy problem of tests/test_engine_equivalence.py (with its
rank-4 "ffn/w_gate" leaf, so angle_filter="dense_only" masks a segment),
MLR at K=10 on the synthetic image task, and the paper's CNN at K=3,
tau=2, B=4 (K*N ~ 5M, so the JAX side runs its Pallas kernels).

Tolerance: 1e-5 (rtol and atol), the reference's own engine-equivalence
bound, for all three problems. The CNN's convs run through XLA on the
JAX side and oneDNN on the torch side, which sum the 5x5xC windows in
different orders; on continuous inputs that stays inside 1e-5. The CNN is
fed continuous random images, not the synthetic task's: those
are clipped to exact 0 and 1 plateaus, where neighbouring conv outputs
come within an ulp of each other, and the two frameworks' rounding then
picks different max-pool winners, which routes the gradient through
different pixels (a parity gap recorded in ROADMAP Queue 3; the port's
own flat and tree engines share one conv and agree on any input).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fl as jfl
from repro.core.weighting import AngleState as JAngleState
from repro.data import synthetic as jsyn
from repro.models import small as jsmall
from repro_torch import convert
from repro_torch.core import fl as tfl
from repro_torch.models import small as tsmall

METRIC_KEYS = ("loss", "theta", "theta_smoothed", "weights", "divergence",
               "lr", "cos", "expected_contribution")


def _toy(k, tau=3, b=8, d=12, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": np.zeros((d, 1), np.float32),
              "b": np.zeros((1,), np.float32),
              "ffn": {"w_gate": np.full((1, 1, 4, 4), 0.1, np.float32)}}

    def batches(r):
        x = rng.normal(size=(k, tau, b, d)).astype(np.float32)
        w_true = rng.normal(size=(k, d, 1)).astype(np.float32)
        return x, np.einsum("ktbd,kde->ktbe", x, w_true)

    def jloss(p, batch):
        x, y = batch
        pred = x @ p["w"] + p["b"] + jnp.sum(p["ffn"]["w_gate"] ** 2)
        return jnp.mean((pred - y) ** 2)

    def tloss(p, batch):
        x, y = batch
        pred = x @ p["w"] + p["b"] + torch.sum(p["ffn"]["w_gate"] ** 2)
        return torch.mean((pred - y) ** 2)

    return params, batches, jloss, tloss


def _image(model, k, tau, b, seed=0, continuous=False):
    train, _ = jsyn.make_image_task(seed=seed, num_train=2000, num_test=10)
    rng = np.random.default_rng(seed)
    init = jsmall.MODELS[model][0]
    params = jax.tree.map(np.asarray, init(jax.random.key(seed)))

    def batches(r):
        idx = rng.integers(0, len(train.y), size=(k, tau, b))
        if continuous:
            x = rng.uniform(size=idx.shape + (28, 28, 1)).astype(np.float32)
            return x, train.y[idx]
        return train.x[idx], train.y[idx]

    japply, tapply = jsmall.MODELS[model][1], tsmall.MODELS[model][1]

    def jloss(p, batch):
        return jsmall.classification_loss(japply, p, *batch)

    def tloss(p, batch):
        return tsmall.classification_loss(tapply, p, *batch)

    return params, batches, jloss, tloss


def _run_both(problem, k, method="fedadp", angle_filter="all", rounds=3,
              num_clients=None, sel=None, start_round=0, prox_mu=0.0):
    params, batches, jloss, tloss = problem
    n_pop = num_clients or k
    sel = np.arange(k, dtype=np.int32) if sel is None else np.asarray(sel)
    sizes = (10.0 * (1.0 + np.arange(k))).astype(np.float32)
    data = [batches(r) for r in range(rounds)]
    kw = dict(num_clients=n_pop, clients_per_round=k,
              local_steps=data[0][0].shape[1],
              method=method, angle_filter=angle_filter, base_lr=0.05,
              prox_mu=prox_mu)
    smoothed0 = np.linspace(0.2, 1.0, n_pop).astype(np.float32)
    count0 = np.arange(n_pop, dtype=np.int32) % 3

    jcfg = jfl.FLConfig(engine="flat", **kw)
    jround = jax.jit(jfl.make_round_fn(jloss, jcfg))
    jst = jfl.init_round_state(jcfg, jax.tree.map(jnp.asarray, params))
    jst = jst._replace(angle=JAngleState(jnp.asarray(smoothed0),
                                         jnp.asarray(count0)),
                       round=jnp.int32(start_round))
    tstates, trounds = {}, {}
    for engine in ("flat", "tree"):
        tcfg = tfl.FLConfig(engine=engine, **kw)
        trounds[engine] = tfl.make_round_fn(tloss, tcfg)
        tstates[engine] = convert.round_state_from_numpy(
            tcfg, params, smoothed0, count0, round=start_round,
            device="cpu")
    out = []
    for r, (xb, yb) in enumerate(data):
        jst, jm = jround(jst, (jnp.asarray(xb), jnp.asarray(yb)),
                         jnp.asarray(sel, jnp.int32), jnp.asarray(sizes))
        tm = {}
        for engine in ("flat", "tree"):
            tstates[engine], tm[engine] = trounds[engine](
                tstates[engine], (torch.from_numpy(xb), torch.from_numpy(yb)),
                torch.from_numpy(sel.astype(np.int64)),
                torch.from_numpy(sizes))
        out.append((jst, jax.device_get(jm), dict(tstates), tm))
    return out


def _close(a, b, rtol, atol, msg):
    np.testing.assert_allclose(np.asarray(b, np.float32),
                               np.asarray(a, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _assert_parity(out, rtol=1e-5, atol=1e-5):
    for r, (jst, jm, tst, tm) in enumerate(out):
        jparams = jax.tree.map(np.asarray, jst.params)
        for engine in ("flat", "tree"):
            tp = convert.params_to_numpy(tst[engine].params)
            jax.tree.map(lambda a, b: _close(a, b, rtol, atol,
                                             f"params r{r} {engine}"),
                         jparams, tp)
            _close(jst.angle.smoothed, tst[engine].angle.smoothed.numpy(),
                   rtol, atol, f"smoothed r{r} {engine}")
            assert (np.asarray(jst.angle.count).tolist()
                    == tst[engine].angle.count.tolist())
            assert set(tm[engine]) == set(jm) == set(METRIC_KEYS)
            for key in METRIC_KEYS:
                _close(jm[key], tm[engine][key].numpy(), rtol, atol,
                       f"metric {key} r{r} {engine}")
            jdelta = jax.tree.map(np.asarray, jst.prev_delta)
            jax.tree.map(lambda a, b: _close(a, b, rtol, atol,
                                             f"prev_delta r{r} {engine}"),
                         jdelta, convert.params_to_numpy(
                             tst[engine].prev_delta))


@pytest.mark.parametrize("angle_filter", ["all", "dense_only"])
@pytest.mark.parametrize("method", ["fedadp", "fedavg", "fedprox"])
def test_toy_round_matches_jax_flat(method, angle_filter):
    prox = 0.1 if method == "fedprox" else 0.0
    out = _run_both(_toy(4), 4, method, angle_filter, rounds=4,
                    prox_mu=prox)
    _assert_parity(out)


def test_dense_only_mask_bites_in_the_port():
    """The segment mask must change the port's angles (the w_gate deltas
    are nonzero), identically in both engines."""
    a = _run_both(_toy(4), 4, angle_filter="all", rounds=1)[0][3]
    m = _run_both(_toy(4), 4, angle_filter="dense_only", rounds=1)[0][3]
    for engine in ("flat", "tree"):
        assert not np.allclose(a[engine]["theta"].numpy(),
                               m[engine]["theta"].numpy())


def test_toy_subset_selection_and_lr_schedule():
    """Partial participation (4 of 8 population slots, ragged K=4 of 8)
    from a non-zero round: the Eq. 9 scatter touches only the selected
    slots and the lr follows base_lr * decay^round."""
    out = _run_both(_toy(4), 4, rounds=2, num_clients=8, sel=[1, 3, 6, 7],
                    start_round=5)
    _assert_parity(out)
    count = out[-1][2]["flat"].angle.count.tolist()
    assert [count[i] - (i % 3) for i in range(8)] == [0, 2, 0, 2, 0, 0, 2, 2]


@pytest.mark.parametrize("k", [1, 33])
def test_toy_any_k(k):
    _assert_parity(_run_both(_toy(k), k, rounds=2))


@pytest.mark.parametrize("method", ["fedadp", "fedavg"])
def test_mlr_round_matches_jax_flat(method):
    _assert_parity(_run_both(_image("mlr", 10, tau=2, b=16), 10, method,
                             rounds=3))


def test_cnn_round_matches_jax_flat():
    """The paper's CNN at full width; the JAX flat round runs its Pallas
    kernels here (K*N = 4,990,110 elements)."""
    out = _run_both(_image("cnn", 3, tau=2, b=4, continuous=True), 3,
                    rounds=2)
    _assert_parity(out)
