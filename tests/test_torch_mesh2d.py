"""The port's 2D (client x model) mesh against the JAX package's on
Auto-axis meshes of 8 host devices, and against itself.

The port's side is one gloo world of 8 CPU ranks (`torch.multiprocessing`
on a `file://` store, joined with a timeout) that builds both a (2, 4)
and a (4, 2) ("data", "model") mesh (`make_client_mesh(model=4)` and
`model=2`); the JAX side is one subprocess with 8 host devices and
`jax.make_mesh(shape, ("data", "model"), axis_types=Auto)` meshes
entered with `jax.set_mesh` (jax's default Explicit axes refuse the
reference's `with_sharding_constraint`). Both run one table of cases
on the same numpy inputs once per module and save npz files that the
parametrised tests read (the harness of tests/test_torch_shard_map.py).

The rounds are the reference's 2D toy (tests/test_engine_equivalence.py
:358, tests/test_buffered.py:480): params wq (12, 8) and w_down (8, 1),
model-sharded by `param_pspecs`, b (1,) and scale (5,) replicated; tau
= 2, B = 4, group size 8, 2 rounds from a nonzero angle state, round 1
of every port engine from the JAX state after round 0 (on a bf16 or int
wire a last-bit difference in the params can train a delta that rounds
to another wire value). Held:

* every rank ends every round, and every region call, with the same
  bits;
* port 2D flat_sharded == JAX 2D flat_sharded on both meshes and all
  four wires at K = 6 (so the (4, 2) mesh pads the client axis to 8):
  params rtol = atol = 1e-5, weights rtol 1e-5 / atol 1e-6, smoothed
  angles and the other metrics 1e-5; fedavg and an angle predicate too
  (round 1 on a quantized wire inside the port only: see
  `test_round_2d_matches_jax`);
* port 2D tree == port 2D flat_sharded at 1e-5 (both read the blocked
  wire); on f32 and bf16 both == the port's 1D flat engine at 1e-5;
* the buffered 2D flush at K = 3 on the (2, 4) mesh (N = 110 padded to
  112 columns) == JAX's, == the sync 2D round at 1e-6 on f32, and ==
  the buffered tree engine at 1e-5 on f32 and int8;
* `make_round_ops_2d` on injected deltas (wq (8, 256) model-sharded, b
  (7,)) == JAX's on every wire; inside the region no all_gather is as
  large as the sharded leaf, and each output leaf has its
  `NamedSpec(mesh, spec).shard_shape`; `fedadp_aggregate` (tree, flat
  on every wire) == JAX's; `make_blocked_roundtrip` == JAX's region on
  both meshes to 2^-22 relative, XLA's compiled scales being an ulp off
  (bit for bit against the eager reference in
  tests/test_torch_blocked.py);
* `FedServer(mesh=(2, 4))` on the MLR task: f32 == the flat engine at
  1e-5, scanned == stepwise bit for bit, and a kill/resume of a scanned
  int8 run == the uninterrupted run bit for bit; telemetry from rank 0
  only.

The mesh's own layout (coordinates, sub-groups, the axes' collectives)
and the refusals run here too.
"""
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
WORLD = 8
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
TOL = 1e-5
JOIN_TIMEOUT = 240  # seconds for the gloo world and the JAX subprocess
D, H, TAU, B, GS = 12, 8, 2, 4, 8
ALPHA = 5.0
WIRES = ("f32", "bf16", "int8", "int4")

# name -> K, population, mesh (None: both), FLConfig fields
ROUND_CASES = {
    **{w: dict(k=6, cfg=dict(transport=w)) for w in WIRES},
    "fedavg_int8": dict(k=6, mesh="2x4", cfg=dict(method="fedavg",
                                                  transport="int8")),
    "keep_int4": dict(k=6, mesh="4x2", keep=("wq", "b"),
                      cfg=dict(transport="int4")),
    "buffered_f32": dict(k=3, clients=8, sel=[1, 4, 6], mesh="2x4",
                         cfg=dict(aggregation="buffered")),
    "buffered_int8": dict(k=3, clients=8, sel=[1, 4, 6], mesh="2x4",
                          cfg=dict(aggregation="buffered",
                                   transport="int8")),
}
INT_KEYS = ("count", "flushed", "buffer_landed")
REGION_K, REGION_D, REGION_H = 8, 8, 256
AGG_ENGINES = ("tree", "flat-f32", "flat-bf16", "flat-int8", "flat-int4")
ROUNDTRIP_WIRES = ("int8", "int4")


# ------------------------------------------------------------- the inputs


def case_of(name):
    c = dict(ROUND_CASES[name])
    c.setdefault("clients", c["k"])
    return c


def case_meshes(name):
    m = case_of(name).get("mesh")
    return list(MESHES) if m is None else [m]


def toy_inputs(name):
    """The case's numpy inputs: params, per-round batches (X, Y), the
    cohort, data sizes, the initial angle state."""
    c = case_of(name)
    k = c["k"]
    rng = np.random.default_rng(sorted(ROUND_CASES).index(name))
    params = {"wq": (0.1 * rng.normal(size=(D, H))).astype(np.float32),
              "w_down": (0.1 * rng.normal(size=(H, 1))).astype(np.float32),
              "b": np.zeros((1,), np.float32),
              "scale": np.full((5,), 0.3, np.float32)}
    xs = rng.normal(size=(2, k, TAU, B, D)).astype(np.float32)
    wt = rng.normal(size=(k, D, 1)).astype(np.float32)
    ys = np.einsum("rktbd,kde->rktbe", xs, wt).astype(np.float32)
    sel = np.asarray(c.get("sel", np.arange(k)), np.int64)
    sizes = np.linspace(10.0, 40.0, k, dtype=np.float32)
    smoothed = np.linspace(0.2, 1.0, c["clients"]).astype(np.float32)
    count = (np.arange(c["clients"]) % 3).astype(np.int32)
    return params, xs, ys, sel, sizes, smoothed, count


def cfg_fields(name):
    c = case_of(name)
    return dict(num_clients=c["clients"], clients_per_round=c["k"],
                local_steps=TAU, base_lr=0.05, group_size=GS, alpha=ALPHA,
                **c["cfg"])


def keep_pred(name):
    keep = case_of(name).get("keep")
    return None if keep is None else (lambda keys, leaf: keys[-1] in keep)


def region_inputs():
    """The reference's no-gather fixture (tests/test_engine_equivalence.py
    :436), with sizes and an angle state."""
    rng = np.random.default_rng(11)
    deltas = {"wq": rng.normal(size=(REGION_K, REGION_D, REGION_H))
              .astype(np.float32),
              "b": rng.normal(size=(REGION_K, 7)).astype(np.float32)}
    sizes = rng.uniform(10.0, 50.0, REGION_K).astype(np.float32)
    smoothed = rng.uniform(0.1, 1.2, REGION_K).astype(np.float32)
    count = rng.integers(0, 4, REGION_K).astype(np.int32)
    return deltas, sizes, smoothed, count


REGION_SPECS = {"wq": (None, "model"), "b": (None,)}


def _state_dict(prefix, values):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in values.items()
            if v is not None}


OPS_KEYS = ("g", "dots", "sqs", "sqg", "delta", "theta", "theta_sm", "w")


# ------------------------------------------------------------ the JAX side


def jax_main(out_path):
    """Every case through the JAX package on (2, 4) and (4, 2) Auto-axis
    meshes of 8 host devices; saved to out_path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.core import fl as jfl
    from repro.core import fl_shard_map as jsm
    from repro.core import treemath as jtm
    from repro.core import weighting as jweighting

    assert jax.device_count() == WORLD, jax.devices()
    enter = getattr(jax.sharding, "use_mesh", None) or jax.set_mesh
    res = {}

    def loss_fn(p, batch):
        x, y = batch
        pred = ((x @ p["wq"]) @ p["w_down"] + p["b"]
                + jnp.sum(p["scale"] ** 2))
        return jnp.mean((pred - y) ** 2)

    def flat(tree):
        return np.asarray(jtm.tree_ravel(tree)[0])

    for mname, shape in MESHES.items():
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        with enter(mesh):
            for name in ROUND_CASES:
                if mname not in case_meshes(name):
                    continue
                params, xs, ys, sel, sizes, sm0, cnt0 = toy_inputs(name)
                cfg = jfl.FLConfig(engine="flat_sharded", **cfg_fields(name))
                rf = jax.jit(jfl.make_round_fn(loss_fn, cfg, None,
                                               keep_pred(name), mesh=mesh))
                st = jfl.init_round_state(cfg,
                                          jax.tree.map(jnp.asarray, params))
                st = st._replace(angle=jweighting.AngleState(
                    jnp.asarray(sm0), jnp.asarray(cnt0)))
                for r in range(2):
                    st, m = rf(st, (jnp.asarray(xs[r]), jnp.asarray(ys[r])),
                               jnp.asarray(sel, jnp.int32),
                               jnp.asarray(sizes))
                    res.update(_state_dict(f"{mname}/{name}/r{r}", {
                        "params": flat(st.params),
                        "prev_delta": flat(st.prev_delta),
                        "angle": st.angle.smoothed, "count": st.angle.count,
                        **{f"m/{k}": v for k, v in m.items()}}))
                    if r == 0:  # the state every port engine's round 1
                        # starts from
                        res.update(_state_dict(f"{mname}/{name}/state0", {
                            **{f"params/{k}": v
                               for k, v in st.params.items()},
                            **{f"prev_delta/{k}": v
                               for k, v in st.prev_delta.items()},
                            "angle": st.angle.smoothed,
                            "count": st.angle.count, "round": st.round,
                            **({} if st.buf is None else {
                                f"buf/{k}": v for k, v in
                                st.buf._asdict().items()})}))
    _save(out_path + ".rounds.npz", res)
    res = {}
    for mname, shape in MESHES.items():
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        with enter(mesh):
            deltas, sizes, sm, cnt = region_inputs()
            jd = jax.tree.map(jnp.asarray, deltas)
            pspecs = {k: P(*v) for k, v in REGION_SPECS.items()}
            psi = jweighting.fedavg_weights(jnp.asarray(sizes))
            for wire in WIRES:
                op = jsm.make_round_ops_2d(mesh, jd, pspecs, alpha=ALPHA,
                                           transport=wire, group_size=GS)
                out = jax.jit(op)(jd, psi, jnp.asarray(sm), jnp.asarray(cnt),
                                  jnp.asarray(sizes))
                res.update(_state_dict(f"{mname}/region/{wire}", {
                    k: (flat(v) if isinstance(v, dict) else v)
                    for k, v in zip(OPS_KEYS, out)}))
            for wire in ROUNDTRIP_WIRES:
                rt = jsm.make_blocked_roundtrip(mesh, jd, pspecs,
                                                transport=wire,
                                                group_size=GS)
                out = jax.jit(rt)(jd)
                res.update({f"{mname}/roundtrip/{wire}/{k}": np.asarray(v)
                            for k, v in out.items()})
            if mname == "2x4":
                stacked = {k: P("data", *v) for k, v in REGION_SPECS.items()}
                for eng in AGG_ENGINES:
                    engine, _, wire = eng.partition("-")
                    agg = jsm.fedadp_aggregate(
                        mesh, stacked, alpha=ALPHA, engine=engine,
                        transport=wire or "f32", group_size=GS)
                    delta, theta, theta_sm, w = jax.jit(agg)(
                        jd, jnp.asarray(sizes), jnp.asarray(sm),
                        jnp.asarray(cnt))
                    res.update(_state_dict(f"{mname}/agg/{eng}", {
                        "delta": flat(delta), "theta": theta,
                        "theta_sm": theta_sm, "w": w}))
    _save(out_path, res)


def _save(path, res):
    """np.savez to `path`, seen by a waiting reader only when whole."""
    np.savez(path + ".part.npz", **res)
    os.replace(path + ".part.npz", path)


def _load_when_written(path):
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.2)
    return dict(np.load(path))


# ----------------------------------------------------------- the port side


def _tensor(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def _tloss(p, batch):
    x, y = batch
    pred = (x @ p["wq"]) @ p["w_down"] + p["b"] + torch.sum(p["scale"] ** 2)
    return torch.mean((pred - y) ** 2)


def _jax_state(cfg, jx, prefix):
    """The port's RoundState from the JAX state saved under `prefix` (the
    buffer only where `cfg` keeps one)."""
    from repro_torch import convert

    def part(name):
        return {k[len(f"{prefix}/{name}/"):]: v for k, v in jx.items()
                if k.startswith(f"{prefix}/{name}/")}

    buf = part("buf") if cfg.aggregation == "buffered" else None
    return convert.round_state_from_numpy(
        cfg, part("params"), jx[f"{prefix}/angle"], jx[f"{prefix}/count"],
        round=int(jx[f"{prefix}/round"]), device="cpu", buf=buf or None,
        prev_delta=part("prev_delta"))


def _port_rounds(name, mesh, jx, mname, engine="flat_sharded", prefix=None,
                 **change):
    """The case's 2 rounds on the port, {prefix/r/key: array}: round 0
    from the initial state, round 1 from the JAX mesh `mname`'s state
    after round 0 (a one-round comparison each: on a bf16 or int wire a
    last-bit difference in the params would train deltas that round to
    another wire value)."""
    from repro_torch.core import fl as tfl
    from repro_torch.core import treemath as ttm
    from repro_torch.core.weighting import AngleState

    params, xs, ys, sel, sizes, sm0, cnt0 = toy_inputs(name)
    cfg = tfl.FLConfig(engine=engine, **{**cfg_fields(name), **change})
    rf = tfl.make_round_fn(_tloss, cfg, None, keep_pred(name), mesh=mesh)
    st = tfl.init_round_state(cfg, {k: torch.from_numpy(v)
                                    for k, v in params.items()})
    st = st._replace(angle=AngleState(torch.from_numpy(sm0),
                                      torch.from_numpy(cnt0)))
    res = {}
    for r in range(2):
        if r == 1:
            st = _jax_state(cfg, jx, f"{mname}/{name}/state0")
        st, m = rf(st, (torch.from_numpy(xs[r]), torch.from_numpy(ys[r])),
                   torch.from_numpy(sel), torch.from_numpy(sizes))
        res.update(_state_dict(f"{prefix}/r{r}", {
            "params": ttm.tree_ravel(st.params)[0].numpy(),
            "prev_delta": ttm.tree_ravel(st.prev_delta)[0].numpy(),
            "angle": st.angle.smoothed.numpy(),
            "count": st.angle.count.numpy(),
            **{f"m/{k}": _tensor(v) for k, v in m.items()}}))
    return res


def _port_region(mesh, mname):
    """make_round_ops_2d, make_blocked_roundtrip and fedadp_aggregate on
    injected deltas: the outputs (model-sharded leaves gathered after
    the call), each output leaf's shape, and the region's largest
    all_gather."""
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.core import treemath as ttm
    from repro_torch.core import weighting as tw
    from repro_torch.models.sharding import NamedSpec

    deltas, sizes, sm, cnt = region_inputs()
    t = torch.from_numpy
    td = {k: t(v) for k, v in deltas.items()}
    psi = tw.fedavg_weights(t(sizes))
    rows = tsm.flat_client_sharding(mesh).rows(REGION_K)
    local = tsm.local_blocks(mesh, {k: v[rows] for k, v in td.items()},
                             REGION_SPECS)
    res = {}
    for wire in WIRES:
        op = tsm.make_round_ops_2d(mesh, td, REGION_SPECS, alpha=ALPHA,
                                   transport=wire, group_size=GS)
        with mesh.recording() as log:
            out = list(op(local, psi, t(sm), t(cnt), t(sizes)))
        gathers = [c.nbytes // 4 for c in log
                   if c.op == "all_gather" and c.scope == "round_ops_2d"]
        res[f"{mname}/shapes/{wire}/max_region_gather"] = np.asarray(
            max(gathers) * mesh.model)
        for key in ("g", "delta"):
            tree = out[OPS_KEYS.index(key)]
            for leaf, spec in REGION_SPECS.items():
                want = NamedSpec(mesh, spec).shard_shape(
                    deltas[leaf].shape[1:])
                res[f"{mname}/shapes/{wire}/{key}/{leaf}"] = np.asarray(
                    [tuple(tree[leaf].shape) == want])
        out[0], out[4] = tsm.gather_model_sharded(mesh, [out[0], out[4]],
                                                  REGION_SPECS)
        res.update(_state_dict(f"{mname}/region/{wire}", {
            k: (ttm.tree_ravel(v)[0].numpy() if isinstance(v, dict)
                else v.numpy()) for k, v in zip(OPS_KEYS, out)}))
    for wire in ROUNDTRIP_WIRES:
        rt = tsm.make_blocked_roundtrip(mesh, td, REGION_SPECS,
                                        transport=wire, group_size=GS)
        res.update({f"{mname}/roundtrip/{wire}/{k}": v.numpy()
                    for k, v in rt(td).items()})
    if mname == "2x4":
        stacked = {k: ("data",) + v for k, v in REGION_SPECS.items()}
        for eng in AGG_ENGINES:
            engine, _, wire = eng.partition("-")
            agg = tsm.fedadp_aggregate(mesh, stacked, alpha=ALPHA,
                                       engine=engine,
                                       transport=wire or "f32",
                                       group_size=GS)
            delta, theta, theta_sm, w = agg(td, t(sizes), t(sm), t(cnt))
            res.update(_state_dict(f"{mname}/agg/{eng}", {
                "delta": ttm.tree_ravel(delta)[0].numpy(), "theta": theta,
                "theta_sm": theta_sm, "w": w}))
    return res


def _port_layout(mesh, mname):
    """The rank's coordinates and each axis's collectives on its rank
    number."""
    r = torch.tensor([float(mesh.rank)])
    return {f"{mname}/layout/coords": np.asarray(
                [mesh.client_index, mesh.model_index, mesh.client_size,
                 mesh.model_size]),
            f"{mname}/layout/sum_data": mesh.all_reduce(r.clone()).numpy(),
            f"{mname}/layout/sum_model": mesh.all_reduce(
                r.clone(), axes=("model",)).numpy(),
            f"{mname}/layout/sum_both": mesh.all_reduce(
                r.clone(), axes=("data", "model")).numpy(),
            f"{mname}/layout/gather_model": mesh.all_gather(
                r, axes=("model",)).numpy()}


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
                                   engine=engine, base_lr=0.05, **kw)
        return repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50,
                                     seed=0, mesh=mesh, device="cpu")

    a = server(clients_per_round=8)
    res.update(_server_dict("server/stepwise", a, a.run(4, eval_every=2)))
    b = server(clients_per_round=8)
    res.update(_server_dict("server/scanned", b, b.run(
        4, eval_every=2, mode="scanned", block=2)))
    if mesh.rank == 0:
        f = server(engine="flat", clients_per_round=8)
        res.update(_server_dict("solo/server/flat", f,
                                f.run(4, eval_every=2)))

    # kill/resume of a scanned int8 run, 5 of 8 clients a round (the 2D
    # wire takes no error feedback); rank 0 writes the shared checkpoint
    ckpt = os.path.join(shared_dir, "ckpt")
    kw = dict(clients_per_round=5, transport="int8")
    whole = server(**kw)
    res.update(_server_dict("server/whole", whole, whole.run(
        4, eval_every=1, mode="scanned", block=2, ckpt_dir=ckpt)))
    resumed = server(**kw)
    resumed.restore(os.path.join(ckpt, "ckpt_00000002.npz"))
    res.update(_server_dict("server/resumed", resumed, resumed.run(
        2, eval_every=1, mode="scanned", block=2)))

    sink = repro_torch.MemorySink()
    server(clients_per_round=8, telemetry="node").run(
        2, eval_every=1, mode="scanned", block=2, sink=sink)
    res["rank/events/count"] = np.asarray(len(sink.events))
    return res


def _port_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_client_mesh

        meshes = {name: make_client_mesh(device="cpu", model=shape[1])
                  for name, shape in MESHES.items()}
        res = {}
        for mname, mesh in meshes.items():
            res.update(_port_layout(mesh, mname))
            res.update(_port_region(mesh, mname))
        res.update(_port_server(meshes["2x4"], out_dir))
        # the rounds: round 1 starts from the JAX state
        jx = _load_when_written(os.path.join(out_dir, "jax.npz.rounds.npz"))
        for mname, mesh in meshes.items():
            for name in ROUND_CASES:
                if mname not in case_meshes(name):
                    continue
                res.update(_port_rounds(name, mesh, jx, mname,
                                        prefix=f"{mname}/{name}"))
                if "aggregation" in case_of(name)["cfg"]:
                    continue
                res.update(_port_rounds(name, mesh, jx, mname, "tree",
                                        prefix=f"{mname}/tree/{name}"))
        res.update(_port_rounds("buffered_f32", meshes["2x4"], jx, "2x4",
                                prefix="2x4/sync/buffered_f32",
                                aggregation="sync"))
        if rank == 0:
            for mname in MESHES:
                for name in ("f32", "bf16"):
                    res.update(_port_rounds(
                        name, None, jx, mname, "flat",
                        prefix=f"solo/flat/{mname}/{name}"))
            for name in ("buffered_f32", "buffered_int8"):
                res.update(_port_rounds(name, None, jx, "2x4", "tree",
                                        prefix=f"solo/tree/{name}"))
        np.savez(os.path.join(out_dir, f"port_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- the two worlds


def _start_jax(out_dir):
    prog = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "import test_torch_mesh2d as t; "
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
        jx = {**np.load(os.path.join(out_dir, "jax.npz.rounds.npz")),
              **np.load(os.path.join(out_dir, "jax.npz"))}
    return port, jx


def _close(got, want, key, atol=TOL):
    if any(key.endswith(k) for k in INT_KEYS):
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif key.endswith("m/weights"):
        np.testing.assert_allclose(got, want, rtol=TOL,
                                   atol=min(atol, 1e-6), err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=atol,
                                   err_msg=key)


def _keys(results, prefix):
    keys = [k for k in results if k.startswith(prefix)]
    assert keys, prefix
    return keys


def _tail(key, prefix):
    return key[len(prefix):]


# -------------------------------------------------------------- the tests

ROUNDS = [(m, n) for n in ROUND_CASES for m in case_meshes(n)]
SYNC = [(m, n) for m, n in ROUNDS if "aggregation" not in
        case_of(n)["cfg"]]
GROUPS = ([f"{m}/{g}/" for m in MESHES
           for g in ("region", "roundtrip", "shapes", "tree")]
          + [f"{m}/{n}/" for m, n in ROUNDS]
          + ["2x4/agg/", "2x4/sync/", "server/"])


@pytest.mark.parametrize("group", GROUPS)
def test_ranks_agree_bit_for_bit(worlds, group):
    port, _ = worlds
    for key in _keys(port[0], group):
        for r in range(1, WORLD):
            assert port[r][key].dtype == port[0][key].dtype, key
            assert np.array_equal(port[r][key], port[0][key],
                                  equal_nan=True), f"rank {r} {key}"


@pytest.mark.parametrize("mname", list(MESHES))
def test_mesh_layout(worlds, mname):
    """Rank r sits at (r // M, r % M); each axis's collectives span the
    ranks that share the other index, in the axis's order."""
    port, _ = worlds
    c, m = MESHES[mname]
    for r in range(WORLD):
        got = port[r]
        assert got[f"{mname}/layout/coords"].tolist() == [r // m, r % m,
                                                          c, m]
        row = [r // m * m + j for j in range(m)]
        col = [i * m + r % m for i in range(c)]
        assert got[f"{mname}/layout/sum_model"][0] == sum(row)
        assert got[f"{mname}/layout/sum_data"][0] == sum(col)
        assert got[f"{mname}/layout/sum_both"][0] == sum(range(WORLD))
        assert got[f"{mname}/layout/gather_model"].tolist() == row


@pytest.mark.parametrize("mname,name", ROUNDS)
def test_round_2d_matches_jax(worlds, mname, name):
    """At the reference's tolerances: round 0, from the same initial
    state, on every wire, and round 1, from the JAX state after round 0,
    on the f32 wire. On a bf16 or int wire the two frameworks' round-1
    deltas, trained from params that are no longer round numbers, can
    sit a last bit apart and round to wire values one step apart (one
    bf16 ulp moves a client's angle, and so every weight, by ~3e-5 here;
    tests/test_torch_round_q.py counts such elements): there round 1 is
    held inside the port only (tree == flat_sharded, 2D == 1D, the
    ranks), each engine from the same JAX state."""
    port, jx = worlds
    wired = case_of(name)["cfg"].get("transport", "f32") != "f32"
    prefix = f"{mname}/{name}/r"
    keys = _keys(jx, prefix)
    assert set(keys) == set(_keys(port[0], prefix)), prefix
    for key in keys:
        if not (wired and key.startswith(f"{prefix}1/")):
            _close(port[0][key], jx[key], key)


@pytest.mark.parametrize("mname,name", SYNC)
def test_tree_2d_matches_flat_sharded_2d(worlds, mname, name):
    """Both engines read the blocked wire on the same mesh."""
    port, _ = worlds
    prefix = f"{mname}/{name}/"
    for key in _keys(port[0], prefix):
        _close(port[0][f"{mname}/tree/{name}/" + _tail(key, prefix)],
               port[0][key], key)


@pytest.mark.parametrize("mname,name", [(m, n) for m in MESHES
                                        for n in ("f32", "bf16")])
def test_elementwise_wire_2d_matches_1d_flat(worlds, mname, name):
    """f32 and bf16 quantize element by element, so the 2D wire is the
    1D wire and the round is the port's 1D flat round."""
    port, _ = worlds
    prefix = f"{mname}/{name}/"
    for key in _keys(port[0], prefix):
        _close(port[0][key], port[0][f"solo/flat/{mname}/{name}/"
                                     + _tail(key, prefix)], key)


def test_buffered_2d_matches_sync_2d(worlds):
    """A full-cohort flush is the sync round: the column-tiled flush
    (N = 110 padded to 112 over 4 model ranks) == the sync 2D round at
    1e-6 on the f32 wire (the metrics both rounds have)."""
    port, _ = worlds
    prefix = "2x4/buffered_f32/"
    for key in _keys(port[0], "2x4/sync/buffered_f32/"):
        tail = _tail(key, "2x4/sync/buffered_f32/")
        _close(port[0][prefix + tail], port[0][key], key, atol=1e-6)


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_buffered_2d_matches_buffered_tree(worlds, wire):
    """Admission quantizes in tree-ravel order on every engine, so the 2D
    flush equals the unsharded buffered tree engine."""
    port, _ = worlds
    prefix = f"2x4/buffered_{wire}/"
    for key in _keys(port[0], prefix):
        _close(port[0][key], port[0][f"solo/tree/buffered_{wire}/"
                                     + _tail(key, prefix)], key)


@pytest.mark.parametrize("mname,wire", [(m, w) for m in MESHES
                                        for w in WIRES])
def test_region_matches_jax(worlds, mname, wire):
    port, jx = worlds
    for key in _keys(jx, f"{mname}/region/{wire}/"):
        _close(port[0][key], jx[key], key)


@pytest.mark.parametrize("mname,wire", [(m, w) for m in MESHES
                                        for w in WIRES])
def test_region_keeps_sharded_leaves_sharded(worlds, mname, wire):
    """No all_gather inside the region is as large as the model-sharded
    leaf, and each output leaf has its shard_shape."""
    port, _ = worlds
    for r in range(WORLD):
        biggest = int(port[r][f"{mname}/shapes/{wire}/max_region_gather"])
        assert 0 < biggest < REGION_D * REGION_H, (r, biggest)
        for key in _keys(port[r], f"{mname}/shapes/{wire}/"):
            if not key.endswith("max_region_gather"):
                assert port[r][key].all(), (r, key)


@pytest.mark.parametrize("mname,wire", [(m, w) for m in MESHES
                                        for w in ROUNDTRIP_WIRES])
def test_blocked_roundtrip_matches_jax(worlds, mname, wire):
    """The port's blocked roundtrip against the JAX region's on the mesh,
    to 2^-22 relative: XLA's compiled quantizer rounds a few scales
    (`absmax / 127`) one ulp from the eager one, which the port matches
    bit for bit, wire bytes and reconstruction
    (tests/test_torch_blocked.py); a value is its level times the scale,
    so it moves by at most that ulp and its own rounding."""
    port, jx = worlds
    for key in _keys(jx, f"{mname}/roundtrip/{wire}/"):
        np.testing.assert_allclose(port[0][key], jx[key], rtol=2.0 ** -22,
                                   atol=0.0, err_msg=key)


@pytest.mark.parametrize("engine", AGG_ENGINES)
def test_fedadp_aggregate_2d_matches_jax(worlds, engine):
    port, jx = worlds
    for key in _keys(jx, f"2x4/agg/{engine}/"):
        _close(port[0][key], jx[key], key)


def test_server_2d_scanned_matches_stepwise(worlds):
    port, _ = worlds
    for key in _keys(port[0], "server/stepwise/"):
        other = "server/scanned/" + _tail(key, "server/stepwise/")
        assert np.array_equal(port[0][key], port[0][other]), key


def test_server_2d_matches_flat(worlds):
    port, _ = worlds
    for key in _keys(port[0], "server/stepwise/state/"):
        _close(port[0][key], port[0]["solo/" + key.replace(
            "stepwise", "flat")], key)


def test_server_2d_kill_resume_bit_for_bit(worlds):
    port, _ = worlds
    for key in _keys(port[0], "server/whole/"):
        tail = _tail(key, "server/whole/")
        want = port[0][key]
        if tail in ("loss", "accuracy", "weights"):
            want = want[2:]  # the resumed History holds rounds 3-4
        assert np.array_equal(port[0]["server/resumed/" + tail], want), key


def test_server_2d_telemetry_from_rank0_only(worlds):
    port, _ = worlds
    assert int(port[0]["rank/events/count"]) > 0
    for r in range(1, WORLD):
        assert int(port[r]["rank/events/count"]) == 0, r


# ------------------------------------------------ refusals, in this process


def _fake_2d_mesh():
    """A (2, 2) ClientMesh whose groups are never used: all that
    `make_round_fn` reads of a mesh before any collective."""
    from repro_torch.launch.mesh import ClientMesh

    g = object()
    return ClientMesh(group=g, rank=0, size=4, device=torch.device("cpu"),
                      model=2, data_group=g, model_group=g)


@pytest.mark.parametrize("engine", ["tree", "flat_sharded"])
@pytest.mark.parametrize("wire", ["bf16", "int8", "int4"])
def test_error_feedback_on_a_2d_wire_raises(engine, wire):
    from repro_torch.core import fl as tfl
    from repro_torch.launch.mesh import make_host_mesh

    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=1,
                       engine=engine, transport=wire, error_feedback=True)
    with pytest.raises(ValueError, match="shard-local blocked order"):
        tfl.make_round_fn(_tloss, cfg, mesh=_fake_2d_mesh())
    # a client-only mesh and the f32 wire keep error feedback
    tfl.make_round_fn(_tloss, cfg, mesh=None if engine == "tree" else
                      make_host_mesh("cpu"))


def test_a_2d_mesh_needs_its_axis_groups():
    from repro_torch.launch.mesh import ClientMesh

    g, cpu = object(), torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide"):
        ClientMesh(group=g, rank=0, size=6, device=cpu, model=4)
    with pytest.raises(ValueError, match="group of its 'model' axis"):
        ClientMesh(group=g, rank=0, size=4, device=cpu, model=2,
                   data_group=g)
    mesh = _fake_2d_mesh()
    assert (mesh.client_size, mesh.model_size) == (2, 2)
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh.all_reduce(torch.zeros(1), axes=("model", "data"))


def test_recording_lists_each_collective():
    """`recording` lists the collectives of its block with their scope;
    a collective over one rank moves nothing and is not listed."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh("cpu")
    with mesh.recording() as log, mesh.scope("outer"):
        mesh.all_reduce(torch.ones(3))
        assert torch.equal(mesh.all_gather(torch.ones(3)), torch.ones(3))
    assert log == []
    assert mesh._log == {"logs": [], "scope": None}


def test_column_tile_pads_and_cuts():
    """N = 110 over 4 model ranks: tiles of 28 columns, the last holding
    26 and two zero columns; the tiles side by side are the rows, and the
    mask's tiles pad with zeros."""
    from repro_torch.core import fl_shard_map as tsm

    rows = torch.arange(3 * 110, dtype=torch.float32).reshape(3, 110)
    mask = torch.ones(110)
    tiles, masks = [], []
    for j in range(4):
        mesh = type("Rank", (), {"model_index": j,
                                 "shape": {"data": 2, "model": 4}})()
        tile, m = tsm.column_tile(mesh, rows, mask)
        assert tile.shape == (3, 28) and tile.is_contiguous()
        tiles.append(tile)
        masks.append(m)
    assert torch.equal(torch.cat(tiles, dim=1)[:, :110], rows)
    assert not torch.any(tiles[3][:, 26:])
    assert torch.equal(torch.cat(masks), torch.cat([mask, torch.zeros(2)]))
    assert tsm.column_tile(mesh, rows)[1] is None
