"""The port's round on the quantized uplink (transport = bf16 / int8 /
int4, with and without error feedback) against the JAX package.

(a) Server half on injected deltas: the same numpy (K, N) deltas go
    through quantize -> aggregate -> statistics -> angle -> weights ->
    aggregate in both packages, through their public functions (the JAX
    side's Pallas kernels in interpret mode). The wires are equal bit for
    bit, everything after them to 1e-5.
(b) The port's flat engine against its tree engine, which dequantizes
    and never reads the wire: both share one wire, so they agree to 1e-5
    over several rounds, per wire x {fedadp, fedavg} x error feedback.
(c) Whole rounds against the JAX flat round, on the toy problem and MLR
    at K = 10. Each round starts both packages from the JAX round's state
    (params, angles, EF residual, round index) and the same batches,
    `sel_idx` and `data_sizes`. The two frameworks train deltas that
    differ in the last ulp, and a value on a rounding boundary then lands
    in the next quantization step: one step of a scale for int8 / int4,
    one bf16 ulp. Each package's wire is built from its own local update
    of the round, and the elements where they differ are counted (the
    count is in every assertion message). Where the wires agree,
    everything is held to 1e-5; where they differ, only those elements
    are allowed one step times their weight (params: the aggregation
    weight; the global delta: the FedAvg weight; the EF residual: one
    step). The toy problem must need no such allowance.
(d) The EF residual after one round is flat0 - roundtrip(flat0), only in
    the selected rows, and equals JAX's `state.ef` to 1e-5.
(e) error_feedback without `state.ef` raises ValueError.
(f) What the port does not run yet still raises NotImplementedError: the
    2D (client x model) mesh of the sharded engine on a quantized wire.
    Without a mesh, engine="flat_sharded" raises the reference's
    ValueError, and its state builds as in the reference.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fl as jfl
from repro.core import treemath as jtm
from repro.core import weighting as jweighting
from repro.core.weighting import AngleState as JAngleState
from repro.kernels import round_stats as jrs
from repro.kernels import weighted_agg as jwa
from repro_torch import convert
from repro_torch import transport as tq
from repro_torch.core import fl as tfl
from repro_torch.core import treemath as ttm
from repro_torch.core import weighting as tweighting
from repro_torch.kernels import round_stats as trs
from repro_torch.kernels import weighted_agg as twa
from test_torch_kernels import assert_agg_close, assert_stats_close
from test_torch_round import METRIC_KEYS, _image, _toy

WIRES = ["bf16", "int8", "int4"]
CHUNK = tq.CHUNK
TOL = 1e-5


def _jq():
    return importlib.import_module("repro.transport.quantize")


# ------------------------------------- (a) server half on injected deltas


def _jax_server_half(x, psi, sizes, mask, transport, gs):
    q = _jq().quantize(jnp.asarray(x), transport, group_size=gs)
    n = x.shape[1]
    if transport == "bf16":
        def agg(w):
            return jwa.weighted_agg(w, q.values, out_dtype=jnp.float32)
        stats = lambda g: jrs.round_stats(q.values, g, mask)  # noqa: E731
    elif transport == "int8":
        agg = lambda w: jwa.weighted_agg_q(w, q.values, q.scales)  # noqa
        stats = lambda g: jrs.round_stats_q(  # noqa: E731
            q.values, q.scales, g, mask)
    else:
        def agg(w):
            return jwa.weighted_agg_q4(w, q.values, q.scales, n=n,
                                       group_size=gs)
        stats = lambda g: jrs.round_stats_q4(  # noqa: E731
            q.values, q.scales, g, mask, group_size=gs)
    g = agg(jnp.asarray(psi))
    dots, sqs, sqg = stats(g)
    theta = jweighting.instantaneous_angle(dots, sqs, sqg)
    w = jweighting.fedadp_weights(theta, jnp.asarray(sizes))
    return q, [np.asarray(a) for a in (g, dots, sqs, sqg, theta, w, agg(w))]


def _torch_server_half(x, psi, sizes, mask, transport, gs):
    q = tq.quantize(torch.from_numpy(x), transport, group_size=gs)
    n = x.shape[1]
    mask = None if mask is None else torch.from_numpy(np.asarray(mask))
    if transport == "bf16":
        def agg(w):
            return twa.weighted_agg(w, q.values, out_dtype=torch.float32)
        stats = lambda g: trs.round_stats(q.values, g, mask)  # noqa: E731
    elif transport == "int8":
        agg = lambda w: twa.weighted_agg_q(w, q.values, q.scales)  # noqa
        stats = lambda g: trs.round_stats_q(  # noqa: E731
            q.values, q.scales, g, mask)
    else:
        def agg(w):
            return twa.weighted_agg_q4(w, q.values, q.scales, n=n,
                                       group_size=gs)
        stats = lambda g: trs.round_stats_q4(  # noqa: E731
            q.values, q.scales, g, mask, group_size=gs)
    g = agg(torch.from_numpy(psi))
    dots, sqs, sqg = stats(g)
    theta = tweighting.instantaneous_angle(dots, sqs, sqg)
    w = tweighting.fedadp_weights(theta, torch.from_numpy(sizes))
    return q, [a.numpy() for a in (g, dots, sqs, sqg, theta, w, agg(w))]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("transport", WIRES)
def test_server_half_on_injected_deltas(transport, masked):
    k, n, gs = 10, 2 * CHUNK + 601, 512
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(k, n)) * 1e-2
         * (10.0 ** (np.arange(n) // 700 % 4))[None]).astype(np.float32)
    x += rng.normal(size=(1, n)).astype(np.float32) * 3e-2  # shared trend
    sizes = (10.0 * (1.0 + np.arange(k))).astype(np.float32)
    psi = (sizes / sizes.sum()).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones(n, np.float32)
        mask[CHUNK - 301:CHUNK + 5001] = 0.0
    jwire, jout = _jax_server_half(x, psi, sizes, mask, transport, gs)
    twire, tout = _torch_server_half(x, psi, sizes, mask, transport, gs)
    jv = np.asarray(jwire.values)
    tv = (twire.values.view(torch.int16).numpy() if transport == "bf16"
          else twire.values.numpy())
    np.testing.assert_array_equal(tv, jv.view(tv.dtype))
    if twire.scales is not None:
        np.testing.assert_array_equal(twire.scales.numpy(),
                                      np.asarray(jwire.scales))
    xd = tq.dequantize(twire).numpy()
    g, dots, sqs, sqg, theta, w, delta = tout
    jg, jdots, jsqs, jsqg, jtheta, jw, jdelta = jout
    assert_agg_close(g, jg, psi, xd)
    assert_stats_close((dots, sqs, sqg), (jdots, jsqs, jsqg), xd, g, mask)
    np.testing.assert_allclose(theta, jtheta, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(w, jw, rtol=TOL, atol=TOL)
    assert_agg_close(delta, jdelta, w, xd)


# ------------------------------------------ (b) port flat == port tree


def _tcfg(k, transport, method="fedadp", ef=False, gs=8, num_clients=None,
          **kw):
    return dict(num_clients=num_clients or k, clients_per_round=k,
                method=method, base_lr=0.05, transport=transport,
                group_size=gs, error_feedback=ef, **kw)


def _assert_states_close(a, b, ma, mb, what, tol=TOL):
    for field in ("params", "prev_delta"):
        np.testing.assert_allclose(
            ttm.tree_ravel(getattr(b, field))[0].numpy(),
            ttm.tree_ravel(getattr(a, field))[0].numpy(), rtol=tol,
            atol=tol, err_msg=f"{what} {field}")
    np.testing.assert_allclose(b.angle.smoothed.numpy(),
                               a.angle.smoothed.numpy(), rtol=tol, atol=tol,
                               err_msg=f"{what} smoothed")
    assert torch.equal(a.angle.count, b.angle.count)
    assert (a.ef is None) == (b.ef is None)
    if a.ef is not None:
        np.testing.assert_allclose(b.ef.numpy(), a.ef.numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{what} ef")
    assert set(ma) == set(mb) == set(METRIC_KEYS)
    for key in METRIC_KEYS:
        np.testing.assert_allclose(mb[key].numpy(), ma[key].numpy(),
                                   rtol=tol, atol=tol,
                                   err_msg=f"{what} metric {key}")


def _port_rounds(problem, k, rounds, cfg_kw, engines=("flat", "tree"),
                 sel=None):
    params, batches, _, tloss = problem
    n_pop = cfg_kw["num_clients"]
    sel = np.arange(k) if sel is None else np.asarray(sel)
    sizes = (10.0 * (1.0 + np.arange(k))).astype(np.float32)
    data = [batches(r) for r in range(rounds)]
    smoothed0 = np.linspace(0.2, 1.0, n_pop).astype(np.float32)
    count0 = np.arange(n_pop, dtype=np.int32) % 3
    out = {}
    for engine in engines:
        cfg = tfl.FLConfig(engine=engine, local_steps=data[0][0].shape[1],
                           **cfg_kw)
        round_fn = tfl.make_round_fn(tloss, cfg)
        st = convert.round_state_from_numpy(cfg, params, smoothed0, count0,
                                            device="cpu")
        hist = []
        for xb, yb in data:
            st, m = round_fn(st, (torch.from_numpy(xb), torch.from_numpy(yb)),
                             torch.from_numpy(sel.astype(np.int64)),
                             torch.from_numpy(sizes))
            hist.append((st, m))
        out[engine] = hist
    return out


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("method", ["fedadp", "fedavg"])
@pytest.mark.parametrize("transport", WIRES)
def test_flat_equals_tree_per_wire(transport, method, ef):
    out = _port_rounds(_toy(4), 4, 3, _tcfg(4, transport, method, ef))
    for r, ((sf, mf), (st, mt)) in enumerate(zip(out["flat"], out["tree"])):
        _assert_states_close(sf, st, mf, mt, f"{transport} r{r}")
        if ef:
            assert sf.ef.abs().max() > 0


@pytest.mark.parametrize("transport", WIRES)
def test_flat_equals_tree_dense_only_partial(transport):
    """The segment mask in logical columns, partial participation (4 of 8
    slots) and error feedback: unselected EF rows stay zero."""
    out = _port_rounds(_toy(4), 4, 2, _tcfg(
        4, transport, ef=True, num_clients=8, angle_filter="dense_only"),
        sel=[1, 3, 6, 7])
    for r, ((sf, mf), (st, mt)) in enumerate(zip(out["flat"], out["tree"])):
        _assert_states_close(sf, st, mf, mt, f"{transport} r{r}")
        assert not sf.ef[[0, 2, 4, 5]].any()
        assert sf.ef[[1, 3, 6, 7]].abs().amax(dim=1).min() > 0


# ---------------------------------------- (c) whole rounds against JAX


def _flat_wire(deltas_flat, ef_rows, transport, gs, pkg):
    """(dequantized wire, integer or bf16 wire values in logical order)
    of one package's raveled deltas."""
    if pkg == "jax":
        flat = jnp.asarray(deltas_flat)
        if ef_rows is not None:
            flat = flat + jnp.asarray(ef_rows)
        q = _jq().quantize(flat, transport, group_size=gs)
        deq = np.asarray(_jq().dequantize(q))
        vals = (np.asarray(_jq().unpack_int4(q.values)) if transport == "int4"
                else np.asarray(q.values).astype(np.float32))
    else:
        flat = torch.from_numpy(deltas_flat)
        if ef_rows is not None:
            flat = flat + torch.from_numpy(ef_rows)
        q = tq.quantize(flat, transport, group_size=gs)
        deq = tq.dequantize(q).numpy()
        vals = (tq.unpack_int4(q.values).numpy() if transport == "int4"
                else q.values.float().numpy())
    return deq, vals[:, :deltas_flat.shape[1]], q


def _wire_gap(jflat, tflat, ef_rows, transport, gs):
    """|dequantized JAX wire - dequantized port wire| (K, N) at the
    elements whose wire values differ (0 elsewhere), after checking that
    each such gap is at most the gap of the inputs plus one quantization
    step (a tiny delta can sit several bf16 ulps of its own from the
    other framework's and still be 1e-7 of the row apart)."""
    jdeq, jvals, jq = _flat_wire(jflat, ef_rows, transport, gs, "jax")
    tdeq, tvals, _ = _flat_wire(tflat, ef_rows, transport, gs, "torch")
    differ = jvals != tvals
    gap = np.where(differ, np.abs(jdeq.astype(np.float64) - tdeq), 0.0)
    if transport == "bf16":  # one bf16 ulp: at most 2^-7 of the value
        step = np.maximum(np.abs(jdeq), np.abs(tdeq)) * 2.0 ** -7
    else:
        cols = CHUNK if transport == "int8" else gs
        step = np.repeat(np.asarray(jq.scales), cols, axis=1)[
            :, :jflat.shape[1]]
    dx = np.abs(jflat.astype(np.float64) - tflat)
    assert np.all(gap <= dx + step * (1 + 1e-6) + 1e-30), "more than a step"
    return gap


def _local_deltas(jloss, tloss, params, xb, yb, lr):
    jd, _ = jax.jit(jax.vmap(
        lambda b: jfl.local_update(jloss, jax.tree.map(jnp.asarray, params),
                                   b, lr)))((jnp.asarray(xb), jnp.asarray(yb)))
    tp = convert.params_from_numpy(params, "cpu")
    td, _ = torch.func.vmap(lambda b: tfl.local_update(tloss, tp, b, lr))(
        (torch.from_numpy(xb), torch.from_numpy(yb)))
    return (np.asarray(jtm.tree_ravel_stacked(jd)[0]),
            ttm.tree_ravel_stacked(td)[0].numpy())


def _with_allowance(got, want, allow, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = TOL + TOL * np.abs(want) + allow
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{msg}: {int(bad.sum())} elements off, worst "
                           f"{np.max(np.abs(got - want) - bound)}")


def _rounds_against_jax(problem, k, transport, ef, gs, rounds):
    params, batches, jloss, tloss = problem
    sel = np.arange(k)
    sizes = (10.0 * (1.0 + np.arange(k))).astype(np.float32)
    kw = _tcfg(k, transport, ef=ef, gs=gs)
    tau = batches(0)[0].shape[1]
    jcfg = jfl.FLConfig(engine="flat", local_steps=tau, **kw)
    jround = jax.jit(jfl.make_round_fn(jloss, jcfg))
    jst = jfl.init_round_state(jcfg, jax.tree.map(jnp.asarray, params))
    jst = jst._replace(angle=JAngleState(
        jnp.linspace(0.2, 1.0, k).astype(jnp.float32),
        jnp.arange(k, dtype=jnp.int32) % 3))
    tround = {e: tfl.make_round_fn(tloss, tfl.FLConfig(
        engine=e, local_steps=tau, **kw)) for e in ("flat", "tree")}
    differing = []
    for r in range(rounds):
        xb, yb = batches(r)
        jp = jax.tree.map(np.asarray, jst.params)
        jef = None if jst.ef is None else np.asarray(jst.ef)
        lr = float(jfl._lr_at(jcfg, r))
        jflat, tflat = _local_deltas(jloss, tloss, jp, xb, yb, lr)
        gap = _wire_gap(jflat, tflat, None if jef is None else jef[sel],
                        transport, gs)
        count = int(np.count_nonzero(gap))
        differing.append(count)
        tstates = {e: convert.round_state_from_numpy(
            tfl.FLConfig(engine=e, local_steps=tau, **kw), jp,
            np.asarray(jst.angle.smoothed), np.asarray(jst.angle.count),
            round=r, device="cpu", ef=jef) for e in tround}
        jst, jm = jround(jst, (jnp.asarray(xb), jnp.asarray(yb)),
                         jnp.asarray(sel, jnp.int32), jnp.asarray(sizes))
        jm = jax.device_get(jm)
        w = np.asarray(jm["weights"], np.float64)
        psi = sizes / sizes.sum()
        for e, fn in tround.items():
            st, m = fn(tstates[e],
                       (torch.from_numpy(xb), torch.from_numpy(yb)),
                       torch.from_numpy(sel.astype(np.int64)),
                       torch.from_numpy(sizes))
            msg = f"{transport} r{r} {e}, {count} wire elements differ"
            p_allow = (w[:, None] * gap).sum(0)
            g_allow = (psi[:, None] * gap).sum(0)
            tflat_p = ttm.tree_ravel(st.params)[0].numpy()
            jflat_p = np.asarray(jtm.tree_ravel(jst.params)[0])
            _with_allowance(tflat_p, jflat_p, p_allow, msg + " params")
            _with_allowance(ttm.tree_ravel(st.prev_delta)[0].numpy(),
                            np.asarray(jtm.tree_ravel(jst.prev_delta)[0]),
                            g_allow, msg + " prev_delta")
            if ef:
                _with_allowance(st.ef.numpy(), np.asarray(jst.ef),
                                gap, msg + " ef")
            np.testing.assert_allclose(st.angle.smoothed.numpy(),
                                       np.asarray(jst.angle.smoothed),
                                       rtol=TOL, atol=TOL, err_msg=msg)
            for key in METRIC_KEYS:
                np.testing.assert_allclose(m[key].numpy(), jm[key],
                                           rtol=TOL, atol=TOL,
                                           err_msg=f"{msg} metric {key}")
    return differing


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("transport", WIRES)
def test_toy_rounds_match_jax_flat(transport, ef):
    differing = _rounds_against_jax(_toy(4), 4, transport, ef, gs=8,
                                    rounds=3)
    assert differing == [0, 0, 0], "the toy's wires must be identical"


@pytest.mark.parametrize("transport,ef", [("bf16", False), ("int8", False),
                                          ("int4", False), ("int8", True)])
def test_mlr_rounds_match_jax_flat(transport, ef):
    differing = _rounds_against_jax(_image("mlr", 10, tau=2, b=16), 10,
                                    transport, ef, gs=tq.GROUP_SIZE,
                                    rounds=2)
    print(f"MLR {transport} ef={ef}: wire elements that differ per round "
          f"{differing} of {10 * 7850}")


# ---------------------------------------- (d) the EF residual, (e), (f)


def test_ef_residual_after_one_round():
    params, batches, jloss, tloss = _toy(4)
    sel = np.array([1, 3, 6, 7])
    xb, yb = batches(0)
    out = _port_rounds((params, lambda r: (xb, yb), jloss, tloss), 4, 1,
                       _tcfg(4, "int8", ef=True, num_clients=8),
                       engines=("flat",), sel=sel)
    st = out["flat"][0][0]
    tp = convert.params_from_numpy(params, "cpu")
    td, _ = torch.func.vmap(lambda b: tfl.local_update(tloss, tp, b, 0.05))(
        (torch.from_numpy(xb), torch.from_numpy(yb)))
    flat0 = ttm.tree_ravel_stacked(td)[0]
    want = flat0 - tq.roundtrip(flat0, "int8")
    assert torch.equal(st.ef[torch.from_numpy(sel)], want)
    assert not st.ef[[0, 2, 4, 5]].any()
    # JAX's residual from the same start
    jcfg = jfl.FLConfig(engine="flat", local_steps=xb.shape[1],
                        **_tcfg(4, "int8", ef=True, num_clients=8))
    jst = jfl.init_round_state(jcfg, jax.tree.map(jnp.asarray, params))
    jst = jst._replace(angle=JAngleState(
        jnp.linspace(0.2, 1.0, 8).astype(jnp.float32),
        jnp.arange(8, dtype=jnp.int32) % 3))
    jst, _ = jax.jit(jfl.make_round_fn(jloss, jcfg))(
        jst, (jnp.asarray(xb), jnp.asarray(yb)), jnp.asarray(sel, jnp.int32),
        jnp.asarray((10.0 * (1.0 + np.arange(4))).astype(np.float32)))
    np.testing.assert_allclose(st.ef.numpy(), np.asarray(jst.ef), rtol=TOL,
                               atol=TOL)


def test_error_feedback_needs_the_residual():
    params, batches, _, tloss = _toy(4)
    cfg = tfl.FLConfig(local_steps=3, engine="flat",
                       **_tcfg(4, "int4", ef=True))
    st = tfl.init_round_state(cfg, convert.params_from_numpy(params, "cpu"))
    assert st.ef.shape == (4, tfl.param_count(st.params))
    assert tfl.init_round_state(dataclasses.replace(
        cfg, error_feedback=False), st.params).ef is None
    xb, yb = batches(0)
    with pytest.raises(ValueError, match="state.ef"):
        tfl.make_round_fn(tloss, cfg)(
            st._replace(ef=None), (torch.from_numpy(xb),
                                   torch.from_numpy(yb)),
            torch.arange(4), torch.ones(4))
    with pytest.raises(ValueError, match="error_feedback"):
        convert.round_state_from_numpy(
            dataclasses.replace(cfg, error_feedback=False), params,
            np.zeros(4), np.zeros(4), device="cpu", ef=np.zeros((4, 29)))


@pytest.mark.parametrize("change", [
    dict(transport="bf16", error_feedback=True, engine="flat_sharded"),
    dict(transport="int4", engine="flat_sharded", telemetry="node"),
])
def test_what_is_not_ported_still_raises(change):
    from repro_torch.core import fl_shard_map
    from repro_torch.launch.mesh import make_host_mesh

    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=1,
                       **change).validate()
    with pytest.raises(ValueError, match="pass mesh= to make_round_fn"):
        tfl.make_round_fn(lambda p, b: 0.0, cfg)
    with pytest.raises(ValueError, match="needs a mesh with a 'model' "
                       "axis of size > 1"):
        fl_shard_map.make_round_ops_2d(
            make_host_mesh("cpu"), {}, {}, alpha=cfg.alpha,
            method=cfg.method, transport=cfg.transport,
            group_size=cfg.group_size)
    st = tfl.init_round_state(cfg, {"w": torch.zeros(3)})
    assert (st.ef is not None) == cfg.error_feedback
