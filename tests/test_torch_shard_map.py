"""The port's client-sharded engine (`FLConfig(engine="flat_sharded")` on
a `torch.distributed` client mesh) against the JAX package's
`flat_sharded` engine on a 4-device Auto-axis mesh, and against itself.

The port's side is one gloo world of 4 CPU ranks (`torch.multiprocessing`
on a `file://` store, joined with a timeout); the JAX side is one
subprocess with 4 host devices and a `("data",)` mesh of Auto axes
(`jax.make_mesh`'s default Explicit axes refuse the reference's
`with_sharding_constraint`). Both run the same table of cases on the
same numpy inputs once per module; the tests below read the saved
results, so each case is its own test without a new process.

Rounds (the linear toy of tests/test_engine_equivalence.py with its
rank-4 `ffn/w_gate` leaf, tau = 2, B = 4, 2 or 3 rounds from a nonzero
angle state): K = 6 (padded to 8 over 4 ranks, so rank 3 holds padding
only) and K = 4, on f32, bf16 + EF, int8, int4 / int8 down, the int8
delta downlink at 3 of 8 clients with EF, fedavg, the dense_only mask,
telemetry="node", buffered m = K and the int4 / int8 buffered server
under a `fixed_arrival_schedule`. Held:

* every rank ends every round with the same state and metrics, bit for
  bit (all saved values, every case);
* port sharded == JAX flat_sharded at the reference's tolerances:
  params rtol = atol = 1e-5, weights rtol 1e-5 / atol 1e-6
  (tests/test_engine_equivalence.py:228-236), the other metrics 1e-5,
  integers exactly. The toy's wires agree in both packages (as in
  tests/test_torch_round_q.py, whose counted allowance is zero on the
  toy), so no allowance is used on the quantized wires;
* port sharded == port flat at 1e-5;
* buffered (m = K) == sync, bit for bit;
* `make_round_ops` (every wire), `make_buffered_flush_ops` and
  `fedadp_aggregate` (tree; flat on every wire) called directly on
  injected buffers == the JAX functions on the same mesh, and
  `fedadp_aggregate` == tests/test_shard_map_agg.py's reference math at
  its tolerances;
* through `FedServer(mesh=)` on the MLR task: scanned == stepwise and a
  kill/resume of a scanned run == the uninterrupted run, bit for bit;
  sharded == flat at 1e-5; the telemetry stream comes from rank 0 only
  and scanned == stepwise.

The rest runs in this process: the refusals (no mesh, a 2D region on a
client-only mesh, a mesh on another device), `tree_ravel_stacked(sharding=)`, and the
padding helpers.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
TOL = 1e-5
JOIN_TIMEOUT = 240  # seconds for the gloo world and the JAX subprocess
D, TAU, B = 12, 2, 4
ALPHA = 5.0

# name -> K, population, rounds, the cohort of each round (None: 0..K-1),
# the case whose data it shares, FLConfig fields, and for the buffered
# server an arrival schedule
ROUND_CASES = {
    "f32": dict(k=6, cfg={}),
    "f32_k4": dict(k=4, cfg={}),
    "bf16_ef": dict(k=6, cfg=dict(transport="bf16", error_feedback=True)),
    "int8": dict(k=6, cfg=dict(transport="int8")),
    "int4_int8": dict(k=6, cfg=dict(transport="int4", downlink="int8",
                                    group_size=8)),
    "int8_delta_partial": dict(
        k=3, clients=8, sel=[[1, 4, 6], [0, 4, 7]],
        cfg=dict(transport="int8", error_feedback=True, downlink="int8",
                 downlink_delta=True, downlink_ring=2)),
    "fedavg": dict(k=6, cfg=dict(method="fedavg")),
    "mask": dict(k=6, cfg=dict(angle_filter="dense_only")),
    "telemetry": dict(k=6, cfg=dict(telemetry="node", downlink="int8",
                                    downlink_delta=True)),
    "buffered_f32": dict(k=6, data="f32", cfg=dict(aggregation="buffered")),
    "buffered_int4_int8": dict(
        k=6, clients=8, rounds=3,
        sel=[[0, 1, 2, 3, 4, 5], [6, 7, 0, 1, 2, 3], [4, 5, 6, 7, 0, 1]],
        cfg=dict(aggregation="buffered", buffer_m=3, transport="int4",
                 downlink="int8", group_size=8, telemetry="node"),
        delays=[[0, 1, 0, 2, 0, 0], [0, 0, 1, 0, 0, 0], [0] * 6],
        drops=[[False] * 4 + [True, False], [False] * 6, [False] * 6]),
}
INT_KEYS = ("count", "tel/nodes", "tel/cohort", "tel/landed", "tel/ages",
            "tel/occupancy", "flushed", "buffer_landed")
DIRECT_WIRES = ("f32", "bf16", "int8", "int4")
DIRECT_K, DIRECT_N, DIRECT_GS = 8, 20_000, 32  # N spans two int8 chunks
AGG_ENGINES = ("tree", "flat-f32", "flat-bf16", "flat-int8", "flat-int4")


# ------------------------------------------------------------- the inputs


def case_of(name):
    c = dict(ROUND_CASES[name])
    c.setdefault("clients", c["k"])
    c.setdefault("rounds", 2)
    return c


def toy_inputs(name):
    """The case's numpy inputs: params, per-round batches (X, Y), cohorts
    and data sizes, the initial angle state."""
    c = case_of(name)
    k, rounds = c["k"], c["rounds"]
    rng = np.random.default_rng(sorted(ROUND_CASES).index(
        c.get("data", name)))
    params = {"w": np.zeros((D, 1), np.float32),
              "b": np.zeros((1,), np.float32),
              "ffn": {"w_gate": np.full((1, 1, 4, 4), 0.1, np.float32)}}
    w_true = rng.normal(size=(k, D, 1)).astype(np.float32)
    xs = rng.normal(size=(rounds, k, TAU, B, D)).astype(np.float32)
    ys = np.einsum("rktbd,kde->rktbe", xs, w_true).astype(np.float32)
    sels = [np.asarray(s, np.int64) for s in c.get("sel") or
            [np.arange(k)] * rounds]
    sizes = np.linspace(10.0, 40.0, k, dtype=np.float32)
    smoothed = np.linspace(0.2, 1.0, c["clients"]).astype(np.float32)
    count = (np.arange(c["clients"]) % 3).astype(np.int32)
    return params, xs, ys, sels, sizes, smoothed, count


def cfg_fields(name):
    c = case_of(name)
    return dict(num_clients=c["clients"], clients_per_round=c["k"],
                local_steps=TAU, base_lr=0.05, **c["cfg"])


def direct_inputs():
    rng = np.random.default_rng(123)
    x = (0.01 * rng.normal(size=(DIRECT_K, DIRECT_N))).astype(np.float32)
    x[:, 7_000:9_000] *= 5.0
    sizes = rng.uniform(10.0, 50.0, DIRECT_K).astype(np.float32)
    mask = np.ones(DIRECT_N, np.float32)
    mask[3_000:5_000] = 0.0
    smoothed = rng.uniform(0.1, 1.2, DIRECT_K).astype(np.float32)
    count = rng.integers(0, 4, DIRECT_K).astype(np.int32)
    age = np.array([0, 1, 0, 2, 0, 0, 1, 0], np.int32)
    landed = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    deltas = {"a": rng.normal(size=(DIRECT_K, 8, 6)).astype(np.float32),
              "b": rng.normal(size=(DIRECT_K, 16)).astype(np.float32)}
    return x, sizes, mask, smoothed, count, age, landed, deltas


# ------------------------------------------------------------ the JAX side


def jax_main(out_path):
    """Every case through the JAX package's flat_sharded engine and its
    fl_shard_map functions on a (4,) Auto-axis mesh; saved to out_path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.core import fl as jfl
    from repro.core import fl_shard_map as jsm
    from repro.core import server as jserver
    from repro.core import treemath as jtm
    from repro.core import weighting as jweighting
    from repro import transport as jtq

    assert jax.device_count() == WORLD, jax.devices()
    mesh = jax.make_mesh((WORLD,), ("data",), axis_types=(AxisType.Auto,))
    enter = getattr(jax.sharding, "use_mesh", None) or jax.set_mesh
    res = {}

    def loss_fn(p, batch):
        x, y = batch
        pred = x @ p["w"] + p["b"] + jnp.sum(p["ffn"]["w_gate"] ** 2)
        return jnp.mean((pred - y) ** 2)

    with enter(mesh):
        for name in ROUND_CASES:
            c = case_of(name)
            params, xs, ys, sels, sizes, sm0, cnt0 = toy_inputs(name)
            cfg = jfl.FLConfig(engine="flat_sharded", **cfg_fields(name))
            arrival = (jserver.fixed_arrival_schedule(c["delays"],
                                                      c["drops"])
                       if "delays" in c else None)
            rf = jax.jit(jfl.make_round_fn(loss_fn, cfg, mesh=mesh,
                                           arrival_fn=arrival))
            st = jfl.init_round_state(cfg, jax.tree.map(jnp.asarray, params))
            st = st._replace(angle=jweighting.AngleState(jnp.asarray(sm0),
                                                         jnp.asarray(cnt0)))
            for r in range(c["rounds"]):
                st, m = rf(st, (jnp.asarray(xs[r]), jnp.asarray(ys[r])),
                           jnp.asarray(sels[r], jnp.int32),
                           jnp.asarray(sizes))
                res.update(_state_dict(f"{name}/r{r}", {
                    "params": np.asarray(jtm.tree_ravel(st.params)[0]),
                    "prev_delta": np.asarray(jtm.tree_ravel(
                        st.prev_delta)[0]),
                    "angle": st.angle.smoothed, "count": st.angle.count,
                    "ef": st.ef, "dl_ef": st.dl_ef,
                    "buf": None if st.buf is None else st.buf.data,
                    **{f"m/{k}": v for k, v in m.items()}}))

        # the aggregation regions on injected buffers, every wire
        x, sizes, mask, sm, cnt, age, landed, deltas = direct_inputs()
        psi = np.asarray(jweighting.fedavg_weights(jnp.asarray(sizes)))
        for wire in DIRECT_WIRES:
            op = jsm.make_round_ops(mesh, alpha=ALPHA, transport=wire,
                                    group_size=DIRECT_GS)
            q = jtq.quantize(jnp.asarray(x), wire, group_size=DIRECT_GS)
            ins = (q.values,) if q.scales is None else (q.values, q.scales)
            out = jax.jit(op)(*ins, jnp.asarray(psi), jnp.asarray(mask),
                              jnp.asarray(sm), jnp.asarray(cnt),
                              jnp.asarray(sizes))
            res.update(_ops_dict(f"round_ops/{wire}", out))
        psi_b = np.asarray(jweighting.buffered_fedavg_weights(
            jnp.asarray(sizes), jnp.asarray(age), jnp.asarray(landed), 0.3))
        flush = jsm.make_buffered_flush_ops(mesh, alpha=ALPHA, beta=0.3)
        out = jax.jit(flush)(jnp.asarray(x), jnp.asarray(psi_b),
                             jnp.asarray(mask), jnp.asarray(sm),
                             jnp.asarray(cnt), jnp.asarray(sizes),
                             jnp.asarray(age), jnp.asarray(landed))
        res.update(_ops_dict("flush_ops", out))
        specs = {"a": P("data", None, None), "b": P("data", None)}
        jd = jax.tree.map(jnp.asarray, deltas)
        for eng in AGG_ENGINES:
            engine, _, wire = eng.partition("-")
            agg = jsm.fedadp_aggregate(mesh, specs, alpha=ALPHA,
                                       engine=engine,
                                       transport=wire or "f32",
                                       group_size=8)
            delta, theta, theta_sm, w = jax.jit(agg)(
                jd, jnp.asarray(sizes), jnp.asarray(sm), jnp.asarray(cnt))
            res.update(_state_dict(f"agg/{eng}", {
                "delta": np.asarray(jtm.tree_ravel(delta)[0]),
                "theta": theta, "theta_sm": theta_sm, "w": w}))
    np.savez(out_path, **res)


OPS_KEYS = ("g_flat", "dots", "sqs", "sqg", "delta_flat", "theta",
            "theta_sm", "w")


def _state_dict(prefix, values):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in values.items()
            if v is not None}


def _ops_dict(prefix, outs):
    return _state_dict(prefix, dict(zip(OPS_KEYS, outs)))


# ----------------------------------------------------------- the port side


def _tensor(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def _tloss(p, batch):
    x, y = batch
    pred = x @ p["w"] + p["b"] + torch.sum(p["ffn"]["w_gate"] ** 2)
    return torch.mean((pred - y) ** 2)


def _port_rounds(name, mesh, engine="flat_sharded"):
    import repro_torch
    from repro_torch.core import fl as tfl
    from repro_torch.core import treemath as ttm
    from repro_torch.core.weighting import AngleState

    c = case_of(name)
    params, xs, ys, sels, sizes, sm0, cnt0 = toy_inputs(name)
    cfg = tfl.FLConfig(engine=engine, **cfg_fields(name))
    arrival = (repro_torch.fixed_arrival_schedule(c["delays"], c["drops"])
               if "delays" in c else None)
    rf = tfl.make_round_fn(_tloss, cfg, mesh=mesh, arrival_fn=arrival)
    tp = {"w": torch.from_numpy(params["w"]),
          "b": torch.from_numpy(params["b"]),
          "ffn": {"w_gate": torch.from_numpy(params["ffn"]["w_gate"])}}
    st = tfl.init_round_state(cfg, tp)
    st = st._replace(angle=AngleState(torch.from_numpy(sm0),
                                      torch.from_numpy(cnt0)))
    res = {}
    for r in range(c["rounds"]):
        st, m = rf(st, (torch.from_numpy(xs[r]), torch.from_numpy(ys[r])),
                   torch.from_numpy(sels[r]), torch.from_numpy(sizes))
        res.update(_state_dict(f"{name}/r{r}", {
            "params": ttm.tree_ravel(st.params)[0].numpy(),
            "prev_delta": ttm.tree_ravel(st.prev_delta)[0].numpy(),
            "angle": st.angle.smoothed.numpy(),
            "count": st.angle.count.numpy(), "ef": _tensor(st.ef),
            "dl_ef": _tensor(st.dl_ef),
            "buf": None if st.buf is None else st.buf.data.numpy(),
            **{f"m/{k}": _tensor(v) for k, v in m.items()}}))
    return res


def _port_direct(mesh):
    from repro_torch import transport as tq
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.core import treemath as ttm
    from repro_torch.core import weighting as tw

    x, sizes, mask, sm, cnt, age, landed, deltas = direct_inputs()
    rows = tsm.flat_client_sharding(mesh).rows(DIRECT_K)
    t = torch.from_numpy
    psi = tw.fedavg_weights(t(sizes))
    res = {}
    for wire in DIRECT_WIRES:
        op = tsm.make_round_ops(mesh, alpha=ALPHA, transport=wire,
                                group_size=DIRECT_GS)
        q = tq.quantize(t(x[rows]), wire, group_size=DIRECT_GS)
        ins = (q.values,) if q.scales is None else (q.values, q.scales)
        out = op(*ins, psi, t(mask), t(sm), t(cnt), t(sizes))
        res.update(_ops_dict(f"round_ops/{wire}", [o.numpy() for o in out]))
    psi_b = tw.buffered_fedavg_weights(t(sizes), t(age), t(landed), 0.3)
    flush = tsm.make_buffered_flush_ops(mesh, alpha=ALPHA, beta=0.3)
    out = flush(t(x[rows]), psi_b, t(mask), t(sm), t(cnt), t(sizes),
                t(age), t(landed))
    res.update(_ops_dict("flush_ops", [o.numpy() for o in out]))
    specs = {"a": ("data", None, None), "b": ("data", None)}
    td = {k: t(v) for k, v in deltas.items()}
    for eng in AGG_ENGINES:
        engine, _, wire = eng.partition("-")
        agg = tsm.fedadp_aggregate(mesh, specs, alpha=ALPHA, engine=engine,
                                   transport=wire or "f32", group_size=8)
        delta, theta, theta_sm, w = agg(td, t(sizes), t(sm), t(cnt))
        res.update(_state_dict(f"agg/{eng}", {
            "delta": ttm.tree_ravel(delta)[0].numpy(), "theta": theta,
            "theta_sm": theta_sm, "w": w}))
    return res


def _server_task():
    from repro_torch.data import synthetic

    train, test = synthetic.make_image_task(seed=0, num_train=3000,
                                            num_test=400)
    nodes = synthetic.make_federated(
        train, [("iid", None)] * 4 + [("xclass", 1)] * 4,
        samples_per_node=100, seed=1)
    return nodes, test


def _server_dict(prefix, server, hist):
    from repro_torch.core import fl as tfl
    from repro_torch.core import treemath as ttm

    st = server.state
    tree = tfl.state_to_tree(st)
    out = {f"{prefix}/state/{'/'.join(map(str, p))}": _tensor(leaf)
           for p, leaf in zip(ttm.tree_paths(tree), ttm.tree_leaves(tree))
           if torch.is_tensor(leaf)}
    out[f"{prefix}/rng"] = st.rng.get_state().numpy()
    out[f"{prefix}/round"] = np.asarray(st.round)
    out[f"{prefix}/loss"] = np.asarray(hist.loss)
    out[f"{prefix}/accuracy"] = np.asarray(hist.accuracy)
    out[f"{prefix}/weights"] = np.asarray(hist.weights)
    return out


def _port_server(mesh, shared_dir):
    import repro_torch

    nodes, test = _server_task()
    res = {}

    def server(engine="flat_sharded", **kw):
        cfg = repro_torch.FLConfig(num_clients=8, local_steps=2,
                                   engine=engine, base_lr=0.05,
                                   transport="int8", **kw)
        return repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50,
                                     seed=0, mesh=mesh, device="cpu")

    # scanned == stepwise (tests/test_driver.py:378)
    a = server(clients_per_round=8)
    res.update(_server_dict("server/stepwise", a, a.run(6, eval_every=2)))
    b = server(clients_per_round=8)
    res.update(_server_dict("server/scanned", b, b.run(
        6, eval_every=2, mode="scanned", block=4)))
    if mesh.rank == 0:
        f = server(engine="flat", clients_per_round=8)
        res.update(_server_dict("solo/server/flat", f,
                                f.run(6, eval_every=2)))

    # kill/resume of a scanned run (tests/test_checkpoint.py:457): 5 of 8
    # clients a round, EF; the checkpoint directory is shared, rank 0
    # writes it
    ckpt = os.path.join(shared_dir, "ckpt")
    kw = dict(clients_per_round=5, error_feedback=True)
    whole = server(**kw)
    res.update(_server_dict("server/whole", whole, whole.run(
        4, eval_every=1, mode="scanned", block=2, ckpt_dir=ckpt)))
    resumed = server(**kw)
    resumed.restore(os.path.join(ckpt, "ckpt_00000002.npz"))
    res.update(_server_dict("server/resumed", resumed, resumed.run(
        2, eval_every=1, mode="scanned", block=2)))

    # the telemetry stream: rank 0 emits, scanned == stepwise
    # (tests/test_telemetry.py:144)
    for mode in ("stepwise", "scanned"):
        sink = repro_torch.MemorySink()
        s = server(clients_per_round=8, telemetry="node")
        s.run(4, eval_every=2, mode=mode, block=2, sink=sink)
        events = [e for e in sink.events if e["event"] in ("round", "node")]
        res[f"rank/events/{mode}/count"] = np.asarray(len(sink.events))
        res[f"solo/events/{mode}"] = np.asarray(json.dumps(
            events, sort_keys=True, default=float))
    return res


def _port_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_client_mesh

        mesh = make_client_mesh(device="cpu")
        res = {}
        for name in ROUND_CASES:
            res.update(_port_rounds(name, mesh))
        if rank == 0:
            res.update({f"solo/flat/{k}": v for name in ROUND_CASES
                        for k, v in _port_rounds(name, None, "flat").items()})
        res.update(_port_direct(mesh))
        res.update(_port_server(mesh, out_dir))
        np.savez(os.path.join(out_dir, f"port_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- the two worlds


def _start_jax(out_dir):
    prog = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "import test_torch_shard_map as t; "
            f"t.jax_main({os.path.join(out_dir, 'jax.npz')!r})")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def worlds():
    """(the port's results per rank, the JAX results), from one gloo world
    of WORLD ranks and one JAX subprocess, run side by side."""
    with tempfile.TemporaryDirectory() as out_dir:
        jax_proc = _start_jax(out_dir)
        ctx = mp.start_processes(
            _port_worker, args=(os.path.join(out_dir, "store"), out_dir),
            nprocs=WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError("the gloo world did not finish in "
                                         f"{JOIN_TIMEOUT} s")
            _, err = jax_proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            if jax_proc.poll() is None:
                jax_proc.kill()
        assert jax_proc.returncode == 0, err[-3000:]
        port = [dict(np.load(os.path.join(out_dir, f"port_rank{r}.npz")))
                for r in range(WORLD)]
        jx = dict(np.load(os.path.join(out_dir, "jax.npz")))
    return port, jx


def _close(got, want, key, rtol=TOL, atol=TOL):
    if any(key.endswith(k) for k in INT_KEYS):
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif key.endswith("m/weights"):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6,
                                   err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=key)


def _keys(results, prefix):
    keys = [k for k in results if k.startswith(prefix)]
    assert keys, prefix
    return keys


# -------------------------------------------------------------- the tests

GROUPS = ([f"{n}/" for n in ROUND_CASES]
          + ["round_ops/", "flush_ops", "agg/", "server/"])


@pytest.mark.parametrize("group", GROUPS)
def test_ranks_agree_bit_for_bit(worlds, group):
    port, _ = worlds
    for key in _keys(port[0], group):
        for r in range(1, WORLD):
            assert port[r][key].dtype == port[0][key].dtype, key
            assert np.array_equal(port[r][key], port[0][key],
                                  equal_nan=True), f"rank {r} {key}"


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_sharded_round_matches_jax_flat_sharded(worlds, name):
    port, jx = worlds
    keys = _keys(jx, f"{name}/")
    assert set(keys) == set(_keys(port[0], f"{name}/")), name
    for key in keys:
        _close(port[0][key], jx[key], key)


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_sharded_round_matches_port_flat(worlds, name):
    port, _ = worlds
    for key in _keys(port[0], f"{name}/"):
        _close(port[0][key], port[0][f"solo/flat/{key}"], key)


def test_buffered_full_cohort_matches_sync(worlds):
    """buffer_m = K with no stragglers is the sync round, bit for bit, on
    the sharded engine too (the buffered tick adds its own metrics)."""
    port, _ = worlds
    for key in _keys(port[0], "f32/"):
        got = port[0]["buffered_f32/" + key[len("f32/"):]]
        assert np.array_equal(got, port[0][key]), key


@pytest.mark.parametrize("wire", DIRECT_WIRES)
def test_round_ops_match_jax(worlds, wire):
    port, jx = worlds
    for key in _keys(jx, f"round_ops/{wire}/"):
        _close(port[0][key], jx[key], key)


def test_buffered_flush_ops_match_jax(worlds):
    port, jx = worlds
    for key in _keys(jx, "flush_ops/"):
        _close(port[0][key], jx[key], key)


@pytest.mark.parametrize("engine", AGG_ENGINES)
def test_fedadp_aggregate_matches_jax(worlds, engine):
    port, jx = worlds
    for key in _keys(jx, f"agg/{engine}/"):
        _close(port[0][key], jx[key], key)


@pytest.mark.parametrize("engine", ["tree", "flat-f32"])
def test_fedadp_aggregate_matches_reference_math(worlds, engine):
    """tests/test_shard_map_agg.py's `_reference` in numpy (f64) at its
    tolerances: theta and w rtol 1e-5, the delta rtol 1e-4 / atol 1e-6."""
    port, _ = worlds
    _, sizes, _, sm, cnt, _, _, deltas = direct_inputs()
    x = np.concatenate([deltas[k].reshape(DIRECT_K, -1).astype(np.float64)
                        for k in sorted(deltas)], axis=1)
    psi = sizes / sizes.sum()
    g = psi @ x
    cos = (x @ g) / (np.sqrt(np.sum(x * x, 1)) * np.sqrt(g @ g))
    theta = np.arccos(np.clip(cos, -1 + 1e-7, 1 - 1e-7))
    c = cnt + 1.0
    sm_new = ((c - 1) * sm + theta) / c
    f = ALPHA * (1 - np.exp(-np.exp(-ALPHA * (sm_new - 1))))
    logits = f + np.log(sizes)
    w = np.exp(logits - logits.max())
    w /= w.sum()
    p = f"agg/{engine}/"
    np.testing.assert_allclose(port[0][p + "theta"], theta, rtol=1e-5)
    np.testing.assert_allclose(port[0][p + "w"], w, rtol=1e-5)
    np.testing.assert_allclose(port[0][p + "delta"], w @ x, rtol=1e-4,
                               atol=1e-6)


def test_server_scanned_matches_stepwise(worlds):
    port, _ = worlds
    for key in _keys(port[0], "server/stepwise/"):
        other = "server/scanned/" + key[len("server/stepwise/"):]
        assert np.array_equal(port[0][key], port[0][other]), key


def test_server_sharded_matches_flat(worlds):
    port, _ = worlds
    for key in _keys(port[0], "server/stepwise/state/"):
        _close(port[0][key], port[0]["solo/" + key.replace(
            "stepwise", "flat")], key)


def test_server_kill_resume_bit_for_bit(worlds):
    """A fresh sharded server restored at round 2 runs rounds 3-4 exactly
    as the uninterrupted scanned run did: state, generator, History."""
    port, _ = worlds
    for key in _keys(port[0], "server/whole/"):
        tail = key[len("server/whole/"):]
        got = port[0]["server/resumed/" + tail]
        want = port[0][key]
        if tail in ("loss", "accuracy", "weights"):
            want = want[2:]  # the resumed History holds rounds 3-4
        assert np.array_equal(got, want), key


def test_telemetry_stream_from_rank0_only(worlds):
    port, _ = worlds
    for mode in ("stepwise", "scanned"):
        assert int(port[0][f"rank/events/{mode}/count"]) > 0
        for r in range(1, WORLD):
            assert int(port[r][f"rank/events/{mode}/count"]) == 0, (r, mode)
    streams = {mode: json.loads(str(port[0][f"solo/events/{mode}"]))
               for mode in ("stepwise", "scanned")}
    assert len([e for e in streams["scanned"] if e["event"] == "node"]) \
        == 4 * 8
    assert streams["stepwise"] == streams["scanned"]


# ------------------------------------------- refusals and helpers, here


def _toy_cfg(**kw):
    from repro_torch.core import fl as tfl

    return tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=1,
                        **kw).validate()


def test_flat_sharded_requires_mesh():
    from repro_torch.core import fl as tfl

    with pytest.raises(ValueError, match="pass mesh= to make_round_fn"):
        tfl.make_round_fn(_tloss, _toy_cfg(engine="flat_sharded"))


def test_model_axis_raises_item_13b():
    """A model axis is now accepted: a ClientMesh carries one (of size 1
    on the host mesh), `make_round_ops_2d` on a mesh whose model axis is
    1 raises the reference's ValueError, and the flat engine on a
    client-only mesh still refuses a model-sharded leaf with the
    reference's message."""
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh("cpu")
    assert (mesh.model, mesh.model_index, mesh.client_index) == (1, 0, 0)
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert tsm.model_axis_size(mesh) == 1
    with pytest.raises(ValueError, match="'model' axis of size > 1"):
        tsm.make_round_ops_2d(mesh, {}, {}, alpha=ALPHA)
    with pytest.raises(ValueError, match="add a 'model' mesh axis"):
        tsm.fedadp_aggregate(mesh, {"a": ("data", None, "model")},
                             alpha=ALPHA, engine="flat")


def test_a_mesh_of_many_ranks_needs_a_group():
    """No collective is quietly a local sum: a ClientMesh of more than one
    rank, or of rank > 0, without a process group is refused."""
    from repro_torch.launch.mesh import ClientMesh

    cpu = torch.device("cpu")
    for size, rank in ((4, 0), (4, 3), (1, 1)):
        with pytest.raises(ValueError, match="needs a process group"):
            ClientMesh(group=None, rank=rank, size=size, device=cpu)
    assert ClientMesh(group=None, rank=0, size=1, device=cpu).size == 1


def test_round_ops_without_a_mask_take_n():
    """mask=None is the unfiltered statistics, as the flat engine passes
    it: equal to a mask of ones on every wire; int4 then takes its
    logical width from n=, and raises without it."""
    from repro_torch import transport as tq
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh("cpu")
    rng = np.random.default_rng(7)
    k, n = 4, 1_001
    x = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    psi = torch.full((k,), 0.25)
    rest = (torch.zeros(k), torch.zeros(k, dtype=torch.int32),
            torch.ones(k))
    for wire in ("f32", "bf16", "int8", "int4"):
        q = tq.quantize(x, wire, group_size=8)
        vals = (q.values,) if q.scales is None else (q.values, q.scales)
        op = tsm.make_round_ops(mesh, alpha=ALPHA, transport=wire,
                                group_size=8)
        ones = op(*vals, psi, torch.ones(n), *rest)
        none = op(*vals, psi, None, *rest, n=n)
        for a, b in zip(ones, none):
            assert torch.equal(a, b), wire
    with pytest.raises(ValueError, match="logical width"):
        op(*vals, psi, None, *rest)


def test_mesh_on_another_device_is_refused():
    """No rank trains or aggregates off its mesh's device: a CUDA mesh
    with CPU tensors raises, as does FedServer given a conflicting
    device."""
    import repro_torch
    from repro_torch.core import fl as tfl
    from repro_torch.launch.mesh import ClientMesh

    cuda_mesh = ClientMesh(group=None, rank=0, size=1,
                           device=torch.device("cuda", 0))
    cfg = _toy_cfg(engine="flat_sharded")
    params = {"w": torch.zeros(3)}
    rf = tfl.make_round_fn(lambda p, b: torch.sum(p["w"] * b[0]), cfg,
                           mesh=cuda_mesh)
    st = tfl.init_round_state(cfg, params)
    with pytest.raises(ValueError, match="mesh runs on cuda:0"):
        rf(st, (torch.ones(4, 1, 3),), torch.arange(4), torch.ones(4))
    nodes, test = _server_task()
    with pytest.raises(ValueError, match="mesh runs on cuda:0"):
        repro_torch.FedServer("mlr", cfg, nodes, test, 50, mesh=cuda_mesh,
                              device="cpu")


def test_make_client_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_client_mesh, make_host_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_client_mesh()
    mesh = make_host_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)


def test_tree_ravel_stacked_takes_a_row_sharding():
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.core import treemath as ttm

    stacked = {"b": torch.arange(8.0).reshape(8, 1),
               "a": torch.arange(24.0).reshape(8, 3)}
    whole, _ = ttm.tree_ravel_stacked(stacked)
    for r in range(4):
        part, unravel = ttm.tree_ravel_stacked(stacked,
                                               tsm.RowShard(r, 4))
        assert torch.equal(part, whole[2 * r:2 * r + 2])
    assert unravel(whole[0])["a"].shape == (3,)
    with pytest.raises(ValueError, match="does not split"):
        ttm.tree_ravel_stacked(stacked, tsm.RowShard(0, 3))


def test_padding_and_row_blocks():
    """K = 6 over 4 ranks pads to 8: ranks 0-2 hold real rows, rank 3
    only padding; `replicate_rows` on a world of one is the rows."""
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.launch.mesh import make_host_mesh

    a = torch.arange(6.0)[:, None] + 1.0
    assert tsm.padded_k(6, 4) == 8
    blocks = [tsm.local_block(a, 8, tsm.RowShard(r, 4), fill=-1.0)
              for r in range(4)]
    assert torch.equal(torch.cat(blocks)[:, 0],
                       torch.tensor([1, 2, 3, 4, 5, 6, -1, -1.0]))
    host = make_host_mesh("cpu")
    assert tsm.padded_k(6, host.size) == 6
    assert torch.equal(tsm.replicate_rows(host, a, 6), a)
    assert tsm.local_block(a, 6, tsm.flat_client_sharding(host)).data_ptr() \
        == a.data_ptr()
