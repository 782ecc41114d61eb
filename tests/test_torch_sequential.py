"""The port's sequential mode (`FLConfig(mode="sequential")`) against the
JAX package.

(a) Against the JAX sequential round on injected inputs: before every
    round both packages start from the JAX round's state (params,
    angles, `prev_delta`, round index), carried across by `convert`, and
    take the same batches, `sel_idx` and `data_sizes`; the new state and
    every metric at 1e-5. fedadp and fedavg, the exact two-pass round and
    `stale_angles=True`, on the toy problem (partial participation) and
    on MLR.
(b) Against the port's own parallel round (tree and flat engines), at
    the reference's bounds (tests/test_engine_equivalence.py:142-151,
    tests/test_fl_engine.py:47-58): params rtol 2e-4 / atol 2e-5, angles,
    theta and weights rtol 2e-4.
(c) The statistics go through `round_stats` on a (1, N) view, one call a
    client, with the angle filter's segment mask ("dense_only"), and no
    aggregation kernel runs.
(d) The reference's config checks: sequential with the flat engine, a
    quantized uplink or a quantized downlink is refused.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import fl as tfl
from test_torch_downlink import rounds_against_jax, toy_problem
from test_torch_round import _image

PARTIAL = [[0, 1, 2, 3], [2, 3, 4, 5], [0, 1, 4, 5]]


# --------------------------------------------------- (a) against JAX


@pytest.mark.parametrize("stale", [False, True], ids=["exact", "stale"])
@pytest.mark.parametrize("method", ["fedadp", "fedavg"])
def test_toy_rounds_match_jax_sequential(method, stale):
    rounds_against_jax(toy_problem(4), 4,
                       dict(mode="sequential", method=method,
                            stale_angles=stale), PARTIAL, num_clients=6,
                       engines=("tree",), jax_engine="tree")


@pytest.mark.parametrize("stale", [False, True], ids=["exact", "stale"])
def test_mlr_rounds_match_jax_sequential(stale):
    rounds_against_jax(_image("mlr", 5, tau=2, b=16), 5,
                       dict(mode="sequential", stale_angles=stale),
                       [[0, 2, 4, 6, 8], [1, 2, 3, 5, 7], [0, 4, 6, 8, 9]],
                       num_clients=10, engines=("tree",), jax_engine="tree")


def test_dense_only_matches_jax_sequential():
    rounds_against_jax(toy_problem(4), 4,
                       dict(mode="sequential", angle_filter="dense_only",
                            prox_mu=0.1, method="fedprox"),
                       PARTIAL, num_clients=6, engines=("tree",),
                       jax_engine="tree")


# ------------------------------------------- (b) against the port's parallel


def _ref_toy(k=4, tau=3, b=8, d=12, seed=0):
    """tests/test_fl_engine.py's problem: linear regression clients with
    heterogeneous targets, zero params."""
    rng = np.random.default_rng(seed)
    params = {"w": np.zeros((d, 1), np.float32),
              "b": np.zeros((1,), np.float32)}
    x = rng.normal(size=(k, tau, b, d)).astype(np.float32)
    y = np.einsum("ktbd,kde->ktbe", x,
                  rng.normal(size=(k, d, 1)).astype(np.float32))

    def loss(p, batch):
        xb, yb = batch
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    return params, loss, (torch.from_numpy(x), torch.from_numpy(y))


def _run(method, rounds=3, **kw):
    params, loss, batches = _ref_toy()
    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=3,
                       method=method, base_lr=0.05, **kw)
    rf = tfl.make_round_fn(loss, cfg)
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    sizes = torch.tensor([10.0, 20.0, 30.0, 40.0])
    ms = []
    for _ in range(rounds):
        st, m = rf(st, batches, torch.arange(4), sizes)
        ms.append(m)
    return st, ms


@pytest.mark.parametrize("engine", ["tree", "flat"])
@pytest.mark.parametrize("method", ["fedadp", "fedavg"])
def test_sequential_matches_parallel(method, engine):
    s_par, m_par = _run(method, engine=engine)
    s_seq, m_seq = _run(method, mode="sequential")
    for key in s_par.params:
        np.testing.assert_allclose(s_seq.params[key].numpy(),
                                   s_par.params[key].numpy(), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_allclose(s_seq.angle.smoothed.numpy(),
                               s_par.angle.smoothed.numpy(), rtol=2e-4)
    assert torch.equal(s_seq.angle.count, s_par.angle.count)
    for key in ("theta", "theta_smoothed", "weights"):
        np.testing.assert_allclose(m_seq[-1][key].numpy(),
                                   m_par[-1][key].numpy(), rtol=2e-4)
    # prev_delta is pass 2's FedAvg-weighted sum: the parallel round's g
    for key in s_par.prev_delta:
        np.testing.assert_allclose(s_seq.prev_delta[key].numpy(),
                                   s_par.prev_delta[key].numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_stale_angles_runs_and_stays_a_simplex():
    st, ms = _run("fedadp", rounds=4, mode="sequential", stale_angles=True)
    for m in ms:
        w = m["weights"].numpy()
        assert np.all(np.isfinite(w)) and abs(w.sum() - 1) < 1e-5
    for p in st.params.values():
        assert bool(torch.isfinite(p).all())
    # round 0's reference is the zero prev_delta: every cosine is 0
    np.testing.assert_allclose(ms[0]["cos"].numpy(), 0.0, atol=1e-6)


# ------------------------------------------------ (c) the (1, N) statistics


@pytest.mark.parametrize("angle_filter", ["all", "dense_only"])
def test_statistics_stream_one_row_a_client(monkeypatch, angle_filter):
    calls = []
    real = tfl.round_stats

    def spy(x, g, mask=None):
        calls.append((tuple(x.shape), tuple(g.shape),
                      None if mask is None else mask.clone()))
        return real(x, g, mask)

    def no_agg(*a, **k):
        raise AssertionError("sequential mode ran an aggregation kernel")

    monkeypatch.setattr(tfl, "round_stats", spy)
    monkeypatch.setattr(tfl, "weighted_agg", no_agg)
    params, batches, _, tloss = toy_problem(4)
    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=3,
                       mode="sequential", angle_filter=angle_filter)
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    xb, yb = batches(0)
    tfl.make_round_fn(tloss, cfg)(
        st, (torch.from_numpy(xb), torch.from_numpy(yb)), torch.arange(4),
        torch.ones(4))
    n = tfl.param_count(st.params)
    assert [c[:2] for c in calls] == [((1, n), (n,))] * 4
    if angle_filter == "all":
        assert all(c[2] is None for c in calls)
    else:
        # keys sort b, ffn, w: the 16 w_gate entries follow b's one
        want = torch.ones(n)
        want[1:17] = 0.0
        assert all(torch.equal(c[2], want) for c in calls)


# ------------------------------------------------ (d) the config checks


@pytest.mark.parametrize("change,match", [
    (dict(engine="flat"), "flat"),
    (dict(transport="int8"), "sequential"),
    (dict(downlink="int8"), "parallel"),
    (dict(aggregation="buffered"), "parallel"),
])
def test_sequential_rejects_what_the_reference_rejects(change, match):
    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=3,
                       mode="sequential", **change)
    with pytest.raises(ValueError, match=match):
        tfl.make_round_fn(lambda p, b: 0.0, cfg)
