"""The port's downlink (`repro_torch.transport.downlink` and the downlink
half of the parallel round) against the JAX package.

(a) The module's functions bit for bit against `repro.transport.downlink`
    (bf16 and int8; f32 passes through) at N in {13, 7850, 16385, 40000};
    `advance_broadcast`'s slots and versions, the bad-ring raise and
    `resync_mask` against the reference's.
(b) The reference's sync scenarios (tests/test_downlink_state.py) on the
    port's rounds, both engines: a re-selected client replaying the ring
    from the base it holds lands bitwise on the head (a stale base plus
    the last delta does not); a client behind a 2-deep ring needs a
    resync; under full participation every client is one version behind
    every round; the `ver` vector after a schedule.
(c) Error feedback: the residual after round 1 is the broadcast's
    quantization error (tests/test_transport.py:586); a quantized
    broadcast stays close to the f32 one (:450).
(d) The master copy: the aggregate lands on the uncompressed params, not
    on the reconstruction the clients trained from.
(e) The port's flat engine against its tree engine at 1e-5, per uplink x
    downlink wire, with EF and delta encoding.
(f) Whole rounds against the JAX flat round: before every round both
    packages start from the JAX round's state (params, angles,
    prev_delta, both EF residuals, the broadcast state), carried across
    by `convert`, with the same batches, `sel_idx` and `data_sizes`; all
    of the new state and every metric at 1e-5. On the toy problem the
    two frameworks' wires are the same, so no allowance is needed; MLR
    runs on the f32 uplink, whose wire does not round.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fl as jfl
from repro.core.weighting import AngleState as JAngleState
from repro_torch import convert
from repro_torch.core import fl as tfl
from repro_torch.core import treemath as ttm
from repro_torch.transport import downlink as tdl
from test_torch_round import METRIC_KEYS, _image

TOL = 1e-5


def _jdl():
    return importlib.import_module("repro.transport.downlink")


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else \
        a.view(f"u{a.dtype.itemsize}")


# ------------------------------------------------ (a) the module's functions


@pytest.mark.parametrize("n", [13, 7850, 16385, 40000])
@pytest.mark.parametrize("downlink", ["f32", "bf16", "int8"])
def test_functions_match_jax_bit_for_bit(downlink, n):
    rng = np.random.default_rng(n)
    vec = (rng.normal(size=n) * 10.0 ** (np.arange(n) // 700 % 4 - 2)
           ).astype(np.float32)
    prev = (vec + rng.normal(size=n).astype(np.float32) * 1e-3).astype(
        np.float32)
    jv, jp = jnp.asarray(vec), jnp.asarray(prev)
    tv, tp = torch.from_numpy(vec), torch.from_numpy(prev)
    pairs = [(tdl.broadcast_roundtrip(tv, downlink),
              _jdl().broadcast_roundtrip(jv, downlink)),
             (tdl.delta_roundtrip(tv, tp, downlink),
              _jdl().delta_roundtrip(jv, jp, downlink))]
    if downlink != "f32":
        tq_, jq_ = tdl.compress(tv, downlink), _jdl().compress(jv, downlink)
        assert tq_.values.shape == (1, n)
        np.testing.assert_array_equal(_bits(tq_.values.view(torch.int16)
                                            if downlink == "bf16"
                                            else tq_.values),
                                      _bits(np.asarray(jq_.values)))
        if downlink == "int8":
            np.testing.assert_array_equal(_bits(tq_.scales),
                                          _bits(jq_.scales))
        pairs += [(tdl.decompress(tq_), _jdl().decompress(jq_)),
                  (tdl.delta_decompress(tdl.delta_compress(tv, tp, downlink),
                                        tp),
                   _jdl().delta_decompress(
                       _jdl().delta_compress(jv, jp, downlink), jp))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="downlink"):
        tdl.compress(tv, "int4")


def test_advance_broadcast_ring_slots_and_versions():
    n = 5
    bs = tdl.init_broadcast_state(n, num_clients=3, ring=2, device="cpu")
    js = _jdl().init_broadcast_state(n, num_clients=3, ring=2)
    assert int(bs.head_ver) == tdl.NEVER_PULLED == _jdl().NEVER_PULLED
    assert bs.head_ver.dtype == bs.ver.dtype == torch.int32
    assert bs.head_ver.shape == () and bs.ver.tolist() == [-1] * 3
    assert list(bs._fields) == list(js._fields)
    rng = np.random.default_rng(0)
    for v in range(4):
        d = rng.normal(size=n).astype(np.float32)
        before = bs
        bs = tdl.advance_broadcast(bs, torch.from_numpy(d))
        js = _jdl().advance_broadcast(js, jnp.asarray(d))
        assert int(bs.head_ver) == v
        np.testing.assert_array_equal(bs.ring[v % 2].numpy(), d)
        assert int(before.head_ver) == v - 1  # the input state is kept
        for field in ("ring", "head"):
            np.testing.assert_array_equal(_bits(getattr(bs, field)),
                                          _bits(getattr(js, field)))
    with pytest.raises(ValueError, match="ring"):
        tdl.init_broadcast_state(4, num_clients=2, ring=0, device="cpu")


def test_resync_mask_matches_jax():
    ver = np.array([-1, 0, 1, 2, 3, 4, 5], np.int32)
    for v in (3, 5):
        for ring in (1, 2, 8):
            got = tdl.resync_mask(torch.from_numpy(ver), v, ring)
            want = _jdl().resync_mask(jnp.asarray(ver), v, ring)
            assert got.tolist() == np.asarray(want).tolist()
    assert bool(tdl.resync_mask(tdl.NEVER_PULLED, 0, 8))
    assert not bool(tdl.resync_mask(3, 4, 2))


def test_init_downlink_error_feedback():
    ef = tdl.init_downlink_error_feedback(7, device="cpu")
    assert ef.shape == (7,) and ef.dtype == torch.float32 and not ef.any()


# ----------------------------------------------- (b) sync scenarios (port)

C, TAU, B, D = 6, 2, 4, 8


def _problem(seed=0, n_clients=C):
    rng = np.random.default_rng(seed)
    params = {"w": np.zeros((D, 1), np.float32),
              "b": np.zeros((1,), np.float32)}
    x = rng.normal(size=(n_clients, TAU, B, D)).astype(np.float32)
    y = np.einsum("ctbd,cde->ctbe", x,
                  rng.normal(size=(n_clients, D, 1)).astype(np.float32))

    def loss(p, batch):
        xb, yb = batch
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    return params, loss, x, y


def _dcfg(engine, **kw):
    base = dict(num_clients=C, clients_per_round=2, local_steps=TAU,
                method="fedadp", base_lr=0.1, downlink="int8",
                downlink_delta=True, engine=engine)
    base.update(kw)
    return tfl.FLConfig(**base)


def _drive(cfg, schedule, seed=0):
    """Yield (round, sel, state) after each round of an explicit
    selection schedule."""
    params, loss, x, y = _problem(seed)
    rf = tfl.make_round_fn(loss, cfg)
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    sizes = torch.full((cfg.clients_per_round,), 10.0)
    for r, sel in enumerate(schedule):
        st, _ = rf(st, (torch.from_numpy(x[sel]), torch.from_numpy(y[sel])),
                   torch.tensor(sel), sizes)
        yield r, sel, st


SCHEDULE = [[0, 1], [2, 3], [4, 5], [1, 2], [0, 3]]


@pytest.mark.parametrize("engine", ["flat", "tree"])
def test_reselected_client_decodes_servers_broadcast(engine):
    """Client 0 pulls at round 0, sits out rounds 1-3 and is re-selected
    at round 4: replaying the ring from the base it holds gives the head
    bitwise; its stale base plus the last delta alone does not."""
    base, base_ver = None, tdl.NEVER_PULLED
    for r, sel, st in _drive(_dcfg(engine), SCHEDULE):
        assert int(st.bcast.head_ver) == r
        if 0 not in sel:
            continue
        if base_ver == tdl.NEVER_PULLED:
            assert bool(tdl.resync_mask(base_ver, int(st.bcast.head_ver), 8))
        else:
            decoded = tdl.client_decode(st.bcast, base, base_ver)
            assert decoded.numpy().tobytes() == st.bcast.head.numpy().tobytes()
            last = st.bcast.ring[r % 8]
            assert (base + last).numpy().tobytes() != \
                st.bcast.head.numpy().tobytes()
        base, base_ver = st.bcast.head.clone(), int(st.bcast.head_ver)
    assert base_ver == 4
    assert st.bcast.ver.tolist() == [4, 3, 3, 4, 2, 2]


@pytest.mark.parametrize("engine", ["flat", "tree"])
def test_client_behind_the_ring_needs_full_resync(engine):
    states = [st for _, _, st in _drive(_dcfg(engine, downlink_ring=2),
                                        SCHEDULE)]
    st3, st4 = states[3], states[4]
    assert int(st3.bcast.ver[0]) == 0
    assert bool(tdl.resync_mask(st3.bcast.ver[0], 4, 2))
    with pytest.raises(ValueError, match="resync"):
        tdl.client_decode(st4.bcast, st4.bcast.ring[0], 0)
    assert not bool(tdl.resync_mask(torch.tensor(3, dtype=torch.int32), 4, 2))
    assert st4.bcast.ver.tolist() == [4, 3, 3, 4, 2, 2]
    # a client one version behind replays one ring row onto its base
    decoded = tdl.client_decode(st4.bcast, st3.bcast.head, 3)
    assert decoded.numpy().tobytes() == st4.bcast.head.numpy().tobytes()


def test_full_participation_every_round_is_one_delta():
    """Every client pulls every round: after round 0's resync each is one
    version behind each round."""
    cfg = _dcfg("flat", clients_per_round=C)
    prev = None
    for r, _, st in _drive(cfg, [list(range(C))] * 3):
        assert st.bcast.ver.tolist() == [r] * C
        want = [True] * C if r == 0 else [False] * C
        before = (torch.full((C,), tdl.NEVER_PULLED, dtype=torch.int32)
                  if prev is None else prev)
        assert tdl.resync_mask(before, r, cfg.downlink_ring).tolist() == want
        prev = st.bcast.ver.clone()


# ------------------------------------------------- (c) error feedback


def _toy_rounds(engine, rounds=3, k=4, params=None, **kw):
    """The reference's transport toy (tests/test_transport.py:_run) on
    the port: K = 4 clients, tau = 3, B = 8, d = 12, all selected."""
    rng = np.random.default_rng(0)
    d = 12
    x = rng.normal(size=(k, 3, 8, d)).astype(np.float32)
    y = np.einsum("ktbd,kde->ktbe", x,
                  rng.normal(size=(k, d, 1)).astype(np.float32))
    if params is None:
        params = {"w": np.zeros((d, 1), np.float32),
                  "b": np.zeros((1,), np.float32)}

    def loss(p, batch):
        xb, yb = batch
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    cfg = tfl.FLConfig(num_clients=k, clients_per_round=k, local_steps=3,
                       engine=engine, base_lr=0.05, **kw)
    rf = tfl.make_round_fn(loss, cfg)
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    sizes = torch.from_numpy((10.0 * (1.0 + np.arange(k))).astype(
        np.float32))
    states = [st]
    for _ in range(rounds):
        st, m = rf(st, (torch.from_numpy(x), torch.from_numpy(y)),
                   torch.arange(k), sizes)
        states.append(st)
    return states, m


NONZERO = {"w": np.full((12, 1), 0.05, np.float32),
           "b": np.full((1,), 0.01, np.float32)}
# every element off the int8 grid of its chunk
RANDOM = {"w": (np.random.default_rng(3).normal(size=(12, 1)) * 0.1
                ).astype(np.float32),
          "b": np.full((1,), 0.01, np.float32)}


def test_downlink_ef_round1_residual_is_broadcast_quant_error():
    pvec, _ = ttm.tree_ravel(convert.params_from_numpy(NONZERO, "cpu"))
    want = pvec - tdl.broadcast_roundtrip(pvec, "int8")
    states, _ = _toy_rounds("flat", rounds=1, params=NONZERO,
                            downlink="int8", downlink_error_feedback=True)
    assert torch.equal(states[1].dl_ef, want)
    assert float(want.abs().sum()) > 0
    # and JAX's residual from the same start
    jwant = np.asarray(
        jnp.asarray(pvec.numpy())
        - _jdl().broadcast_roundtrip(jnp.asarray(pvec.numpy()), "int8"))
    np.testing.assert_allclose(states[1].dl_ef.numpy(), jwant, atol=1e-7)


def test_downlink_ef_carries_across_rounds():
    s_ef, _ = _toy_rounds("flat", params=NONZERO, downlink="int8",
                          downlink_error_feedback=True)
    s_nc, _ = _toy_rounds("flat", params=NONZERO, downlink="int8")
    assert any(not torch.equal(a, b) for a, b in
               zip(s_ef[-1].params.values(), s_nc[-1].params.values()))
    assert bool(torch.isfinite(s_ef[-1].dl_ef).all())
    assert float(s_ef[-1].dl_ef.abs().max()) < 1.0
    assert s_nc[-1].dl_ef is None and s_nc[-1].bcast is None


def test_quantized_downlink_close_to_f32_broadcast():
    s_q, _ = _toy_rounds("flat", params=NONZERO, downlink="int8")
    s_f, _ = _toy_rounds("flat", params=NONZERO)
    for key in s_q[-1].params:
        np.testing.assert_allclose(s_q[-1].params[key].numpy(),
                                   s_f[-1].params[key].numpy(), rtol=1e-5,
                                   atol=2e-2)
    assert any(not torch.equal(a, b) for a, b in
               zip(s_q[-1].params.values(), s_f[-1].params.values()))


@pytest.mark.parametrize("field,kw", [
    ("dl_ef", dict(downlink="int8", downlink_error_feedback=True)),
    ("bcast", dict(downlink="bf16", downlink_delta=True)),
])
def test_round_needs_its_downlink_state(field, kw):
    params, loss, x, y = _problem()
    cfg = tfl.FLConfig(num_clients=C, clients_per_round=C, local_steps=TAU,
                       engine="flat", **kw)
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    assert getattr(st, field) is not None
    with pytest.raises(ValueError, match=f"state.{field}"):
        tfl.make_round_fn(loss, cfg)(
            st._replace(**{field: None}),
            (torch.from_numpy(x), torch.from_numpy(y)), torch.arange(C),
            torch.ones(C))


# --------------------------------------------------- (d) the master copy


@pytest.mark.parametrize("engine", ["flat", "tree"])
def test_delta_lands_on_the_master_copy(engine):
    """After one int8-downlink round, params == old master + the
    aggregated delta (and not reconstruction + delta): the delta is taken
    from a round whose clients train from the same reconstruction."""
    states, _ = _toy_rounds(engine, rounds=1, params=RANDOM,
                            downlink="int8")
    old, new = states[0].params, states[1].params
    pvec, punravel = ttm.tree_ravel(old)
    recon = punravel(tdl.broadcast_roundtrip(pvec, "int8"))
    assert any(not torch.equal(old[k], recon[k]) for k in old)
    # the f32-downlink round started from the reconstruction trains the
    # same clients and aggregates the same delta
    f32_states, _ = _toy_rounds(engine, rounds=1,
                                params=convert.params_to_numpy(recon))
    delta = {k: f32_states[1].params[k] - recon[k] for k in recon}
    for k in old:
        np.testing.assert_allclose(new[k].numpy(), (old[k] + delta[k]).numpy(),
                                   rtol=0, atol=1e-7)
        assert not torch.allclose(new[k], recon[k] + delta[k], rtol=0,
                                  atol=1e-7)


# ---------------------------------------------- (e) port flat == port tree


def _assert_states_close(a, b, ma, mb, what, tol=TOL):
    for field in ("params", "prev_delta"):
        np.testing.assert_allclose(
            ttm.tree_ravel(getattr(b, field))[0].numpy(),
            ttm.tree_ravel(getattr(a, field))[0].numpy(), rtol=tol,
            atol=tol, err_msg=f"{what} {field}")
    np.testing.assert_allclose(b.angle.smoothed.numpy(),
                               a.angle.smoothed.numpy(), rtol=tol, atol=tol)
    assert torch.equal(a.angle.count, b.angle.count)
    for field in ("ef", "dl_ef"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=tol,
                                       atol=tol, err_msg=f"{what} {field}")
    assert (a.bcast is None) == (b.bcast is None)
    if a.bcast is not None:
        for field in ("ring", "head"):
            np.testing.assert_allclose(getattr(b.bcast, field).numpy(),
                                       getattr(a.bcast, field).numpy(),
                                       rtol=tol, atol=tol)
        assert torch.equal(a.bcast.ver, b.bcast.ver)
        assert int(a.bcast.head_ver) == int(b.bcast.head_ver)
    for key in METRIC_KEYS:
        np.testing.assert_allclose(mb[key].numpy(), ma[key].numpy(),
                                   rtol=tol, atol=tol,
                                   err_msg=f"{what} metric {key}")


def _flat_vs_tree(cfg_kw, rounds=3, k=4, num_clients=None, schedule=None):
    rng = np.random.default_rng(5)
    d = 12
    n_pop = num_clients or k
    params = {"w": (rng.normal(size=(d, 1)) * 0.1).astype(np.float32),
              "b": np.full((1,), 0.01, np.float32),
              "ffn": {"w_gate": np.full((1, 1, 4, 4), 0.1, np.float32)}}
    data = []
    for _ in range(rounds):
        x = rng.normal(size=(k, 3, 8, d)).astype(np.float32)
        data.append((x, np.einsum("ktbd,kde->ktbe", x, rng.normal(
            size=(k, d, 1)).astype(np.float32))))

    def loss(p, batch):
        xb, yb = batch
        return torch.mean((xb @ p["w"] + p["b"]
                           + torch.sum(p["ffn"]["w_gate"] ** 2) - yb) ** 2)

    schedule = schedule or [list(range(k))] * rounds
    sizes = torch.from_numpy((10.0 * (1.0 + np.arange(k))).astype(
        np.float32))
    out = {}
    for engine in ("flat", "tree"):
        cfg = tfl.FLConfig(num_clients=n_pop, clients_per_round=k,
                           local_steps=3, engine=engine, base_lr=0.05,
                           **cfg_kw)
        rf = tfl.make_round_fn(loss, cfg)
        st = convert.round_state_from_numpy(
            cfg, params, np.linspace(0.2, 1.0, n_pop),
            np.arange(n_pop) % 3, device="cpu")
        hist = []
        for (x, y), sel in zip(data, schedule):
            st, m = rf(st, (torch.from_numpy(x), torch.from_numpy(y)),
                       torch.tensor(sel), sizes)
            hist.append((st, m))
        out[engine] = hist
    for r, ((sf, mf), (st, mt)) in enumerate(zip(out["flat"], out["tree"])):
        _assert_states_close(sf, st, mf, mt, f"{cfg_kw} r{r}")
    return out


@pytest.mark.parametrize("downlink", ["bf16", "int8"])
@pytest.mark.parametrize("uplink", ["f32", "bf16", "int8", "int4"])
def test_flat_equals_tree_per_wire_pair(uplink, downlink):
    _flat_vs_tree(dict(transport=uplink, downlink=downlink,
                       group_size=32 if uplink == "int4" else 512))


@pytest.mark.parametrize("cfg_kw", [
    dict(transport="int4", group_size=32, downlink="int8",
         downlink_error_feedback=True),
    dict(transport="int8", error_feedback=True, downlink="bf16",
         downlink_error_feedback=True),
    dict(transport="f32", downlink="int8", downlink_delta=True),
    dict(transport="int4", group_size=32, downlink="int8",
         downlink_delta=True, downlink_ring=2, downlink_error_feedback=True,
         angle_filter="dense_only"),
    dict(transport="bf16", downlink="bf16", downlink_delta=True,
         method="fedavg"),
], ids=["int4-ef-down", "int8-ef-both", "delta", "delta-ring2-ef-masked",
        "bf16-delta-fedavg"])
def test_flat_equals_tree_ef_and_delta(cfg_kw):
    out = _flat_vs_tree(cfg_kw, rounds=4, num_clients=6,
                        schedule=[[0, 1, 2, 3], [2, 3, 4, 5], [0, 1, 4, 5],
                                  [1, 2, 3, 5]])
    st = out["flat"][-1][0]
    if cfg_kw.get("downlink_delta"):
        assert st.bcast.ver.tolist() == [2, 3, 3, 3, 2, 3]
        assert int(st.bcast.head_ver) == 3
    if cfg_kw.get("downlink_error_feedback"):
        assert float(st.dl_ef.abs().max()) > 0


# ------------------------------------------ (f) whole rounds against JAX


def _jax_to_port(cfg, jst):
    """The JAX round's state as the port's, through `convert`."""
    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    return convert.round_state_from_numpy(
        cfg, np_tree(jst.params), np.asarray(jst.angle.smoothed),
        np.asarray(jst.angle.count), round=int(jst.round), device="cpu",
        ef=None if jst.ef is None else np.asarray(jst.ef),
        dl_ef=None if jst.dl_ef is None else np.asarray(jst.dl_ef),
        bcast=jst.bcast, buf=jst.buf, prev_delta=np_tree(jst.prev_delta))


def assert_state_matches_jax(st, jst, m, jm, msg, tol=TOL):
    """Every field of the port's new state and every port metric against
    the JAX round's, at `tol` (integer fields exactly)."""
    got = convert.round_state_to_numpy(st)

    def close(a, b, what):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=tol,
                                   atol=tol, err_msg=f"{msg} {what}")

    jax.tree.map(lambda a, b: close(a, b, "params"), got["params"],
                 jax.tree.map(np.asarray, jst.params))
    jax.tree.map(lambda a, b: close(a, b, "prev_delta"), got["prev_delta"],
                 jax.tree.map(np.asarray, jst.prev_delta))
    close(got["angle_smoothed"], jst.angle.smoothed, "smoothed")
    assert got["angle_count"].tolist() == np.asarray(
        jst.angle.count).tolist(), msg
    assert got["round"] == int(jst.round)
    for field in ("ef", "dl_ef"):
        assert (got[field] is None) == (getattr(jst, field) is None), field
        if got[field] is not None:
            close(got[field], getattr(jst, field), field)
    for field in ("bcast", "buf"):
        ours, theirs = got[field], getattr(jst, field)
        assert (ours is None) == (theirs is None), field
        if ours is None:
            continue
        for key, value in ours.items():
            want = np.asarray(getattr(theirs, key))
            if value.dtype.kind == "f":
                close(value, want, f"{field}.{key}")
            else:
                assert value.tolist() == want.tolist(), (msg, field, key)
    for key, value in m.items():
        close(value.numpy(), jm[key], f"metric {key}")


def rounds_against_jax(problem, k, cfg_kw, schedule, num_clients=None,
                       make_arrival=None, engines=("flat", "tree"),
                       jax_engine="flat", tol=TOL):
    """Run the JAX round (`jax_engine`) over `schedule` (one sel list a
    round) and, from the JAX state before each round, the port's
    `engines`; hold every round to the JAX one at `tol`.
    `make_arrival(package)` gives each package's arrival_fn for a
    buffered config. Returns the last JAX state and the JAX metrics."""
    params, batches, jloss, tloss = problem
    n_pop = num_clients or k
    sizes = (10.0 * (1.0 + np.arange(k))).astype(np.float32)
    tau = batches(0)[0].shape[1]
    kw = dict(num_clients=n_pop, clients_per_round=k, local_steps=tau,
              base_lr=0.05, **cfg_kw)
    jcfg = jfl.FLConfig(engine=jax_engine, **kw)
    jround = jax.jit(jfl.make_round_fn(
        jloss, jcfg, arrival_fn=make_arrival("jax") if make_arrival
        else None))
    jst = jfl.init_round_state(jcfg, jax.tree.map(jnp.asarray, params))
    jst = jst._replace(angle=JAngleState(
        jnp.linspace(0.2, 1.0, n_pop).astype(jnp.float32),
        jnp.arange(n_pop, dtype=jnp.int32) % 3))
    tcfgs = {e: tfl.FLConfig(engine=e, **kw) for e in engines}
    trounds = {e: tfl.make_round_fn(
        tloss, c, arrival_fn=make_arrival("torch") if make_arrival else None)
        for e, c in tcfgs.items()}
    metrics = []
    for r, sel in enumerate(schedule):
        xb, yb = batches(r)
        tstates = {e: _jax_to_port(c, jst) for e, c in tcfgs.items()}
        jst, jm = jround(jst, (jnp.asarray(xb), jnp.asarray(yb)),
                         jnp.asarray(sel, jnp.int32), jnp.asarray(sizes))
        jm = jax.device_get(jm)
        for e, fn in trounds.items():
            st, m = fn(tstates[e], (torch.from_numpy(xb),
                                    torch.from_numpy(yb)),
                       torch.tensor(sel), torch.from_numpy(sizes))
            assert_state_matches_jax(st, jst, m, jm, f"{cfg_kw} r{r} {e}",
                                     tol)
        metrics.append(jm)
    return jst, metrics


def toy_problem(k, seed=0):
    """The toy of tests/test_torch_round.py with nonzero params (a zero
    model broadcasts exactly)."""
    rng = np.random.default_rng(seed)
    d = 12
    params = {"w": (rng.normal(size=(d, 1)) * 0.1).astype(np.float32),
              "b": np.full((1,), 0.01, np.float32),
              "ffn": {"w_gate": np.full((1, 1, 4, 4), 0.1, np.float32)}}

    def batches(r):
        g = np.random.default_rng(100 + r)
        x = g.normal(size=(k, 3, 8, d)).astype(np.float32)
        return x, np.einsum("ktbd,kde->ktbe", x, g.normal(
            size=(k, d, 1)).astype(np.float32))

    def jloss(p, batch):
        x, y = batch
        pred = x @ p["w"] + p["b"] + jnp.sum(p["ffn"]["w_gate"] ** 2)
        return jnp.mean((pred - y) ** 2)

    def tloss(p, batch):
        x, y = batch
        pred = x @ p["w"] + p["b"] + torch.sum(p["ffn"]["w_gate"] ** 2)
        return torch.mean((pred - y) ** 2)

    return params, batches, jloss, tloss


PARTIAL = [[0, 1, 2, 3], [2, 3, 4, 5], [0, 1, 4, 5], [1, 2, 3, 5]]


@pytest.mark.parametrize("cfg_kw", [
    dict(downlink="int8"),
    dict(downlink="bf16", downlink_error_feedback=True, transport="int8",
         error_feedback=True),
    dict(downlink="int8", downlink_delta=True, downlink_ring=2,
         transport="int4", group_size=8),
    dict(downlink="bf16", downlink_delta=True, downlink_error_feedback=True,
         method="fedavg", angle_filter="dense_only"),
], ids=["int8", "bf16-ef-int8-ef", "delta-ring2-int4", "delta-ef-fedavg"])
def test_toy_rounds_match_jax_flat(cfg_kw):
    jst, _ = rounds_against_jax(toy_problem(4), 4, cfg_kw, PARTIAL,
                                num_clients=6)
    if cfg_kw.get("downlink_delta"):
        assert np.asarray(jst.bcast.ver).tolist() == [2, 3, 3, 3, 2, 3]


@pytest.mark.parametrize("cfg_kw", [
    dict(downlink="int8", downlink_delta=True),
    dict(downlink="bf16", downlink_error_feedback=True),
], ids=["int8-delta", "bf16-ef"])
def test_mlr_rounds_match_jax_flat(cfg_kw):
    rounds_against_jax(_image("mlr", 5, tau=2, b=16), 5, cfg_kw,
                       [[0, 2, 4, 6, 8], [1, 2, 3, 5, 7], [0, 4, 6, 8, 9]],
                       num_clients=10, engines=("flat",))


def test_state_round_trips_through_convert():
    """round_state_to_numpy then round_state_from_numpy gives the same
    state, and a field the config does not allocate is refused."""
    states, _ = _toy_rounds("flat", rounds=2, params=NONZERO,
                            downlink="int8", downlink_delta=True,
                            downlink_error_feedback=True, transport="int8",
                            error_feedback=True)
    st = states[-1]
    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=3,
                       engine="flat", base_lr=0.05, downlink="int8",
                       downlink_delta=True, downlink_error_feedback=True,
                       transport="int8", error_feedback=True)
    d = convert.round_state_to_numpy(st)
    back = convert.round_state_from_numpy(
        cfg, d["params"], d["angle_smoothed"], d["angle_count"],
        round=d["round"], device="cpu", ef=d["ef"], dl_ef=d["dl_ef"],
        bcast=d["bcast"], prev_delta=d["prev_delta"])
    for a, b in zip(ttm.tree_leaves(back), ttm.tree_leaves(st)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.dtype == b.dtype
    assert back.round == st.round == 2
    with pytest.raises(ValueError, match="downlink_delta"):
        convert.round_state_from_numpy(
            tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=3),
            d["params"], d["angle_smoothed"], d["angle_count"],
            device="cpu", bcast=d["bcast"])
    with pytest.raises(ValueError, match="bcast.ring"):
        convert.round_state_from_numpy(
            cfg, d["params"], d["angle_smoothed"], d["angle_count"],
            device="cpu", bcast=dict(d["bcast"], ring=d["bcast"]["ring"][:1]))
