"""The port's buffered-async server (`FLConfig(aggregation="buffered")`)
against the JAX package.

(a) Units against JAX: `staleness_discount`, `buffered_fedadp_weights`
    and `buffered_fedavg_weights` (their reduction to Eqs. 1 / 11 at age
    0 bit for bit, zeros and no NaN when nothing landed), and the
    `ReportBuffer` state machine (`admit`, `population_busy`,
    `landed_mask`, `advance`) field for field.
(b) Properties, where the reference's draws come from JAX's threefry and
    cannot be reproduced: `select_clients_avoiding` (free clients before
    busy ones, full participation the identity and no draw) and
    `draw_arrivals` (`straggle_max = 0`, the drop stream independent of
    straggling, seed-determinism).
(c) buffered(buffer_m = K, no stragglers) == sync for the reference's
    EQUIV_CASES (tests/test_buffered.py:154-160), at the reference's
    tolerances: 0.0 on tree / flat f32 and tree int8 with EF over 3
    rounds, 1e-5 on flat int4 / int8 and on flat_sharded int8 / int8
    with EF (a world-of-one host mesh) for one.
(d) `test_fixed_schedule_flush_semantics`'s tick-by-tick claims on the
    port's `FedServer(arrival_fn=)`, a stochastic schedule's
    seed-determinism, and a deterministic buffered server walking its
    generator and params exactly as the sync one.
(e) Port ticks against JAX ticks under one `fixed_arrival_schedule`, with
    injected batches and the state carried across by `convert` before
    every tick, at 1e-5, on both engines.
(f) A buffered client's decode base is fixed at admission
    (tests/test_downlink_state.py:187).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import buffer as jbuffer
from repro.core import weighting as jweighting
from repro_torch import convert
from repro_torch.core import buffer as tbuffer
from repro_torch.core import driver
from repro_torch.core import fl as tfl
from repro_torch.core import weighting as tweighting
from repro_torch.data import synthetic
from repro_torch.transport import downlink as tdl
from test_torch_downlink import rounds_against_jax, toy_problem

# ------------------------------------------------------- (a) units vs JAX


def _weights_inputs(seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.1, 1.4, size=6).astype(np.float32)
    sizes = rng.uniform(10, 60, size=6).astype(np.float32)
    age = np.array([0, 1, 2, 0, 4, 3], np.int32)
    return theta, sizes, age


@pytest.mark.parametrize("landed", [
    [True] * 6, [True, True, False, True, False, True], [False] * 6],
    ids=["all", "some", "none"])
@pytest.mark.parametrize("beta", [0.0, 0.3, 0.9])
def test_buffered_weights_match_jax(landed, beta):
    theta, sizes, age = _weights_inputs()
    landed = np.asarray(landed)
    tw = tweighting.buffered_fedadp_weights(
        torch.from_numpy(theta), torch.from_numpy(sizes),
        torch.from_numpy(age), torch.from_numpy(landed), 5.0, beta)
    jw = jweighting.buffered_fedadp_weights(
        jnp.asarray(theta), jnp.asarray(sizes), jnp.asarray(age),
        jnp.asarray(landed), 5.0, beta)
    ta = tweighting.buffered_fedavg_weights(
        torch.from_numpy(sizes), torch.from_numpy(age),
        torch.from_numpy(landed), beta)
    ja = jweighting.buffered_fedavg_weights(
        jnp.asarray(sizes), jnp.asarray(age), jnp.asarray(landed), beta)
    for t, j in ((tw, jw), (ta, ja)):
        assert bool(torch.isfinite(t).all())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
        assert not t[torch.from_numpy(~landed)].any()
    np.testing.assert_allclose(
        tweighting.staleness_discount(torch.from_numpy(age), beta).numpy(),
        np.asarray(jweighting.staleness_discount(jnp.asarray(age), beta)),
        rtol=1e-6)


def test_buffered_weights_reduce_to_sync_at_age_zero():
    theta, sizes, _ = _weights_inputs(1)
    t, s = torch.from_numpy(theta), torch.from_numpy(sizes)
    zero = torch.zeros(6, dtype=torch.int32)
    landed = torch.ones(6, dtype=torch.bool)
    assert torch.equal(
        tweighting.buffered_fedadp_weights(t, s, zero, landed, 5.0, 0.9),
        tweighting.fedadp_weights(t, s, 5.0))
    assert torch.equal(
        tweighting.buffered_fedavg_weights(s, zero, landed, 0.9),
        tweighting.fedavg_weights(s))
    # a report `age` versions older weighs exp(-beta age) as much
    w = tweighting.buffered_fedadp_weights(
        torch.full((4,), 0.7), torch.full((4,), 30.0),
        torch.tensor([0, 1, 2, 4], dtype=torch.int32),
        torch.tensor([True, True, False, False]), 5.0, 0.5)
    np.testing.assert_allclose(float(w[1] / w[0]), np.exp(-0.5), rtol=1e-6)


def _buf_fields(b):
    return {k: np.asarray(v).tolist() for k, v in b._asdict().items()}


def test_report_buffer_state_machine_matches_jax():
    k, n, pop = 4, 5, 9
    tb = tbuffer.init_report_buffer(k, n, device="cpu")
    jb = jbuffer.init_report_buffer(k, n)
    assert _buf_fields(tb) == _buf_fields(jb)
    rng = np.random.default_rng(0)
    steps = [([True, True, False, True], [5, 1, 3, 0], [0, 2, 0, 1], True),
             ([False, False, True, False], [2, 7, 8, 6], [0, 0, 3, 0],
              False),
             ([True, False, False, True], [4, 2, 8, 6], [1, 0, 0, 0], True),
             ([False, True, False, False], [0, 3, 1, 2], [0, 0, 0, 0],
              True)]
    for admit_mask, sel, delay, flush in steps:
        rows = rng.normal(size=(k, n)).astype(np.float32)
        sizes = rng.uniform(10, 40, size=k).astype(np.float32)
        args = (np.asarray(admit_mask), rows, np.asarray(sel, np.int32),
                sizes, np.asarray(delay, np.int32))
        tb = tbuffer.admit(tb, *map(torch.from_numpy, args))
        jb = jbuffer.admit(jb, *map(jnp.asarray, args))
        assert _buf_fields(tb) == _buf_fields(jb)
        assert (tbuffer.population_busy(tb, pop).tolist()
                == np.asarray(jbuffer.population_busy(jb, pop)).tolist())
        tl, jl = tbuffer.landed_mask(tb), jbuffer.landed_mask(jb)
        assert tl.tolist() == np.asarray(jl).tolist()
        tb = tbuffer.advance(tb, tl, torch.tensor(flush))
        jb = jbuffer.advance(jb, jl, jnp.asarray(flush))
        assert _buf_fields(tb) == _buf_fields(jb)
        assert tb.age.dtype == tb.wait.dtype == tb.slot.dtype == torch.int32


# ------------------------------------------------------ (b) properties


def test_select_clients_avoiding_prefers_free_clients():
    busy = torch.tensor([False, True, False, True, False, False])
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        sel = driver.select_clients_avoiding(gen, 6, 3, busy).tolist()
        assert len(set(sel)) == 3 and not set(sel) & {1, 3}
    # more picks than free clients: every free one, then busy ones
    sel = driver.select_clients_avoiding(gen, 6, 5, busy).tolist()
    assert {0, 2, 4, 5} <= set(sel) and len(set(sel)) == 5
    # full participation: the identity, and the generator is not drawn
    state = gen.get_state()
    assert driver.select_clients_avoiding(
        gen, 4, 4, torch.zeros(4, dtype=torch.bool)).tolist() == [0, 1, 2, 3]
    assert torch.equal(gen.get_state(), state)
    # one seed, one selection
    a = driver.select_clients_avoiding(torch.Generator().manual_seed(7), 9,
                                       4, torch.zeros(9, dtype=torch.bool))
    b = driver.select_clients_avoiding(torch.Generator().manual_seed(7), 9,
                                       4, torch.zeros(9, dtype=torch.bool))
    assert torch.equal(a, b)


def test_draw_arrivals_honors_zero_straggle_max():
    def draw(seed, k, **kw):
        return tbuffer.draw_arrivals(torch.Generator().manual_seed(seed), k,
                                     **kw)

    delay, drop = draw(3, 8, straggle_prob=1.0, straggle_max=0,
                       dropout_prob=0.5)
    assert delay.tolist() == [0] * 8 and delay.dtype == torch.int32
    _, drop_on = draw(3, 8, straggle_prob=1.0, straggle_max=3,
                      dropout_prob=0.5)
    assert torch.equal(drop, drop_on)
    delay_on, none = draw(3, 64, straggle_prob=1.0, straggle_max=3,
                          dropout_prob=0.0)
    assert 1 <= int(delay_on.min()) and int(delay_on.max()) <= 3
    assert len(set(delay_on.tolist())) == 3 and not none.any()
    a, b = draw(5, 16, straggle_prob=0.3, straggle_max=2, dropout_prob=0.2), \
        draw(5, 16, straggle_prob=0.3, straggle_max=2, dropout_prob=0.2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0].max()) <= 2


# ------------------------------------- (c) buffered(m = K) == sync


def _toy_rounds(cfg, rounds, sel):
    rng = np.random.default_rng(0)
    k, d = len(sel), 12
    x = rng.normal(size=(k, 3, 8, d)).astype(np.float32)
    y = np.einsum("ktbd,kde->ktbe", x,
                  rng.normal(size=(k, d, 1)).astype(np.float32))
    params = {"w": np.zeros((d, 1), np.float32),
              "b": np.zeros((1,), np.float32)}

    def loss(p, batch):
        xb, yb = batch
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    mesh = (repro_torch.make_host_mesh("cpu")
            if cfg.engine == "flat_sharded" else None)
    rf = tfl.make_round_fn(loss, cfg, mesh=mesh)
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    sizes = torch.tensor([10.0 * (i + 1) for i in range(k)])
    ws = []
    for _ in range(rounds):
        st, m = rf(st, (torch.from_numpy(x), torch.from_numpy(y)),
                   torch.tensor(sel), sizes)
        ws.append(m["weights"].numpy())
    return st, ws


# (engine, uplink, downlink, error_feedback, rounds, atol): the
# reference's EQUIV_CASES
EQUIV_CASES = [
    ("tree", "f32", "f32", False, 3, 0.0),
    ("flat", "f32", "f32", False, 3, 0.0),
    ("tree", "int8", "f32", True, 3, 0.0),
    ("flat", "int4", "int8", False, 1, 1e-5),
    ("flat_sharded", "int8", "int8", True, 1, 1e-5),
]


@pytest.mark.parametrize("engine,uplink,downlink,ef,rounds,atol",
                         EQUIV_CASES)
def test_buffered_full_cohort_matches_sync(engine, uplink, downlink, ef,
                                           rounds, atol):
    base = dict(num_clients=8, clients_per_round=3, local_steps=3,
                method="fedadp", base_lr=0.05, engine=engine,
                transport=uplink, downlink=downlink, error_feedback=ef,
                group_size=512)
    sel = [1, 4, 6]
    st_s, w_s = _toy_rounds(tfl.FLConfig(**base), rounds, sel)
    st_b, w_b = _toy_rounds(tfl.FLConfig(**base, aggregation="buffered"),
                            rounds, sel)
    for key in st_s.params:
        np.testing.assert_allclose(st_b.params[key].numpy(),
                                   st_s.params[key].numpy(), rtol=0,
                                   atol=atol)
    np.testing.assert_allclose(st_b.angle.smoothed.numpy(),
                               st_s.angle.smoothed.numpy(), rtol=0,
                               atol=atol)
    assert torch.equal(st_s.angle.count, st_b.angle.count)
    np.testing.assert_allclose(w_b, w_s, rtol=0, atol=max(atol, 1e-7))
    if ef:
        np.testing.assert_allclose(st_b.ef.numpy(), st_s.ef.numpy(), rtol=0,
                                   atol=atol)
    assert bool(st_b.buf.free.all()) and int(st_b.buf.age.max()) == 0


# ----------------------------------------- (d) flush semantics (FedServer)


def _small_task(seed=0):
    train, test = synthetic.make_image_task(seed=seed, num_train=3000,
                                            num_test=400)
    nodes = synthetic.make_federated(
        train, [("iid", None)] * 2 + [("xclass", 1)] * 2,
        samples_per_node=200, seed=1)
    return nodes, test


def _server(cfg, arrival_fn=None, seed=0):
    nodes, test = _small_task()
    return repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50,
                                 seed=seed, device="cpu",
                                 arrival_fn=arrival_fn)


def _bcfg(**kw):
    base = dict(num_clients=4, clients_per_round=4, local_steps=4,
                base_lr=0.05, aggregation="buffered", buffer_m=3,
                staleness_beta=0.5)
    base.update(kw)
    return repro_torch.FLConfig(**base)


def test_fixed_schedule_flush_semantics():
    """K = 4, buffer_m = 3: tick 0 admits 3 (one dropped) and 2 land, no
    flush, params kept; tick 1 re-admits the dropped client, 3 land and
    flush while the straggler waits; tick 2 the straggler lands at age 1
    and the buffer drains."""
    delays = np.zeros((4, 4), np.int32)
    drops = np.zeros((4, 4), bool)
    delays[0, 1] = 2
    drops[0, 2] = True
    s = _server(_bcfg(), repro_torch.fixed_arrival_schedule(delays, drops))
    p0 = {k: v.clone() for k, v in s.params.items()}
    prev0 = {k: v.clone() for k, v in s.state.prev_delta.items()}

    m = s.step()
    assert int(m["flushed"]) == 0 and int(m["buffer_landed"]) == 2
    for k in p0:
        assert torch.equal(p0[k], s.params[k])
        assert torch.equal(prev0[k], s.state.prev_delta[k])
    assert not s.state.angle.count.any()
    assert s.state.buf.free.tolist() == [False, False, True, False]

    m = s.step()
    assert int(m["flushed"]) == 1 and int(m["buffer_landed"]) == 3
    assert float(m["staleness"]) == 0.0
    assert s.state.buf.free.tolist() == [True, False, True, True]
    assert s.state.buf.age.tolist() == [0, 1, 0, 0]
    assert s.state.angle.count.tolist() == [1, 0, 1, 1]

    m = s.step()
    assert int(m["flushed"]) == 1 and int(m["buffer_landed"]) == 4
    np.testing.assert_allclose(float(m["staleness"]), 1.0 / 4.0, rtol=1e-6)
    assert float(m["weights"][1]) > 0.0
    assert bool(s.state.buf.free.all())
    assert s.round == 3


def test_stochastic_arrivals_are_seed_deterministic():
    cfg = _bcfg(straggle_prob=0.3, straggle_max=2, dropout_prob=0.2)
    a, b = _server(cfg, seed=7), _server(cfg, seed=7)
    flushed = []
    for _ in range(5):
        ma, mb = a.step(), b.step()
        assert int(ma["flushed"]) == int(mb["flushed"])
        assert int(ma["buffer_landed"]) == int(mb["buffer_landed"])
        flushed.append(int(ma["flushed"]))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert torch.equal(a.state.rng.get_state(), b.state.rng.get_state())


@pytest.mark.parametrize("engine", ["flat", "tree"])
def test_deterministic_buffered_server_walks_like_sync(engine):
    """buffer_m = K, no stragglers, full participation: the buffered
    server draws nothing the sync one does not, so after every step both
    hold the same generator state and the same params, bit for bit."""
    kw = dict(num_clients=4, clients_per_round=4, local_steps=4,
              base_lr=0.05, engine=engine)
    sync = _server(repro_torch.FLConfig(**kw), seed=3)
    buf = _server(repro_torch.FLConfig(**kw, aggregation="buffered"), seed=3)
    for _ in range(3):
        ms, mb = sync.step(), buf.step()
        assert torch.equal(sync.state.rng.get_state(),
                           buf.state.rng.get_state())
        np.testing.assert_array_equal(ms["weights"], mb["weights"])
        assert int(mb["flushed"]) == 1
    for k in sync.params:
        assert torch.equal(sync.params[k], buf.params[k])


def test_partial_participation_avoids_busy_clients():
    """6 clients, 3 a tick, every report of tick 0 straggles 2 ticks: the
    next cohorts avoid the 3 busy clients while 3 others are free."""
    delays = np.zeros((4, 3), np.int32)
    delays[0] = 2
    nodes, test = _small_task()
    nodes = nodes + nodes[:2]
    cfg = repro_torch.FLConfig(num_clients=6, clients_per_round=3,
                               local_steps=4, base_lr=0.05,
                               aggregation="buffered", buffer_m=1)
    s = repro_torch.FedServer(
        "mlr", cfg, nodes, test, batch_size=50, device="cpu",
        arrival_fn=repro_torch.fixed_arrival_schedule(
            delays, np.zeros_like(delays, bool)))
    s.step()
    busy0 = set(s.state.buf.slot.tolist())
    assert len(busy0) == 3 and not s.state.buf.free.any()
    m = s.step()  # nothing free: no admission, nothing landed yet
    assert int(m["flushed"]) == 0
    m = s.step()  # the stragglers land and flush
    assert int(m["flushed"]) == 1 and bool(s.state.buf.free.all())


def test_buffered_round_needs_its_buffer():
    params, batches, _, tloss = toy_problem(4)
    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=3,
                       aggregation="buffered")
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    assert st.buf.data.shape == (4, tfl.param_count(st.params))
    xb, yb = batches(0)
    with pytest.raises(ValueError, match="state.buf"):
        tfl.make_round_fn(tloss, cfg)(
            st._replace(buf=None), (torch.from_numpy(xb),
                                    torch.from_numpy(yb)),
            torch.arange(4), torch.ones(4))


def test_golden_schedule_flushes_every_tick():
    """The golden buffered task's schedule (tests/golden/convergence.json:
    10 clients, buffer_m = 8, stragglers at (0, 3) and (2, 7), a drop at
    (1, 5)): every one of its 8 ticks flushes, with the stragglers
    aggregated one version stale at ticks 1 and 3. `chip_smoke.py` holds
    the card to this run's flags."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "convergence.json")) as f:
        t = json.load(f)["buffered"]["task"]
    s = t["schedule"]
    delays = np.zeros((s["ticks"], s["num_clients"]), np.int32)
    drops = np.zeros_like(delays, bool)
    for tk, k in s["stragglers"]:
        delays[tk, k] = s["delay"]
    for tk, k in s["drops"]:
        drops[tk, k] = True
    train, test = synthetic.make_image_task(num_train=12000, num_test=500)
    nodes = synthetic.make_federated(
        train, [("iid", None)] * 5 + [("xclass", 1)] * 5,
        samples_per_node=600, seed=1)
    cfg = repro_torch.FLConfig(
        num_clients=10, clients_per_round=10, local_steps=12, base_lr=0.05,
        engine="flat", aggregation="buffered", buffer_m=t["buffer_m"],
        staleness_beta=t["staleness_beta"])
    srv = repro_torch.FedServer(
        "mlr", cfg, nodes, test, batch_size=50, device="cpu",
        arrival_fn=repro_torch.fixed_arrival_schedule(delays, drops))
    ms = [srv.step() for _ in range(s["ticks"])]
    assert [int(m["flushed"]) for m in ms] == [1] * 8
    assert [int(m["buffer_landed"]) for m in ms] == [9, 9, 9, 10, 10, 10,
                                                      10, 10]
    assert [float(m["staleness"]) > 0 for m in ms] == [
        False, True, False, True, False, False, False, False]


# ------------------------------------------- (e) ticks against JAX ticks


def _make_arrival(delays, drops):
    def make(package):
        if package == "jax":
            return repro.fixed_arrival_schedule(delays, drops)
        return repro_torch.fixed_arrival_schedule(delays, drops)

    return make


SCHED_DELAYS = np.array([[0, 2, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0],
                         [1, 0, 0, 0], [0, 0, 0, 0]], np.int32)
SCHED_DROPS = np.zeros((5, 4), bool)
SCHED_DROPS[0, 3] = True
SCHED_DROPS[2, 0] = True


@pytest.mark.parametrize("cfg_kw", [
    dict(buffer_m=2),
    dict(buffer_m=3, method="fedavg", angle_filter="dense_only"),
    dict(buffer_m=2, transport="int8", error_feedback=True,
         downlink="int8", downlink_delta=True, downlink_ring=2),
    dict(buffer_m=2, transport="int4", group_size=8, downlink="bf16",
         downlink_error_feedback=True),
], ids=["f32", "fedavg-masked", "int8-ef-delta", "int4-bf16-ef"])
def test_ticks_match_jax_under_a_fixed_schedule(cfg_kw):
    schedule = [[0, 1, 2, 3], [4, 1, 2, 5], [0, 3, 4, 5], [1, 2, 3, 0],
                [5, 4, 0, 1]]
    jst, jms = rounds_against_jax(
        toy_problem(4), 4, dict(aggregation="buffered", staleness_beta=0.5,
                                **cfg_kw),
        schedule, num_clients=6,
        make_arrival=_make_arrival(SCHED_DELAYS, SCHED_DROPS))
    # buffer_m = 3 waits at tick 0 (a straggler, a drop); 2 never waits
    assert [int(m["flushed"]) for m in jms] == (
        [0, 1, 1, 1, 1] if cfg_kw["buffer_m"] == 3 else [1] * 5)


# ------------------------------------ (f) decode base fixed at admission


def test_buffered_base_is_fixed_at_admission_time():
    c, tk, tau, b, d = 6, 3, 2, 4, 8
    rng = np.random.default_rng(1)
    params = {"w": np.zeros((d, 1), np.float32),
              "b": np.zeros((1,), np.float32)}
    x = rng.normal(size=(c, tau, b, d)).astype(np.float32)
    y = np.einsum("ctbd,cde->ctbe", x,
                  rng.normal(size=(c, d, 1)).astype(np.float32))

    def loss(p, batch):
        xb, yb = batch
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    delays = np.zeros((5, tk), np.int32)
    delays[0, 0] = 2
    drops = np.zeros((5, tk), bool)
    cfg = tfl.FLConfig(num_clients=c, clients_per_round=tk, local_steps=tau,
                       method="fedadp", base_lr=0.1, downlink="int8",
                       downlink_delta=True, aggregation="buffered",
                       buffer_m=2)
    rf = tfl.make_round_fn(
        loss, cfg,
        arrival_fn=repro_torch.fixed_arrival_schedule(delays, drops))
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    states = []
    for sel in [[0, 1, 2], [0, 3, 4], [0, 1, 2], [0, 3, 4]]:
        st, _ = rf(st, (torch.from_numpy(x[sel]), torch.from_numpy(y[sel])),
                   torch.tensor(sel), torch.full((tk,), 10.0))
        states.append(st)
    assert [int(s.bcast.ver[0]) for s in states] == [0, 0, 0, 3]
    decoded = tdl.client_decode(states[3].bcast, states[0].bcast.head, 0)
    assert decoded.numpy().tobytes() == \
        states[3].bcast.head.numpy().tobytes()
    assert int(states[3].bcast.ver[5]) == tdl.NEVER_PULLED
