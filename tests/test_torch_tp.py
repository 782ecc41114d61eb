"""Tensor-parallel model execution (`models/tp.py`, `make_round_fn(...,
param_specs=)`) on gloo worlds of CPU ranks, against the JAX package and
against the port's whole-model 2D round.

One gloo world of 8 CPU ranks (`torch.multiprocessing` spawn, `file://`
store) builds a (2, 4), a (4, 2) and a (1, 8) ("data", "model") mesh;
one JAX subprocess runs the reference, with 8 host devices for its 2D
wire. Both sides draw the same numpy inputs from seeds; the port starts
from the JAX init (written first, read by the world). Held:

* **Against the JAX package.** `build_train_step`'s fn on each mesh
  (K = the client axis: 2, 4, 1; T = 64, B = global batch 4 / K) for
  every supported smoke config: gemma-2b (tied, G = 1), granite-20b
  (untied, G = 1, `loss_chunk`), minitron-4b (G = 2, flash),
  starcoder2-15b (G = 2), the LM example's preset cut to 2 layers
  and vocab 512 (tied, flash, `loss_chunk`) and deepseek-v2-lite-16b
  (MLA + MoE: E = 4 expert-parallel on M = 2 and 4, each expert's last
  dim split on M = 8; also with `angle_filter="dense_only"` on (2, 4)),
  against the JAX package's
  unsharded tree round jitted, over 2 rounds at 1e-5: params,
  prev_delta, the smoothed angles, loss, theta, weights, divergence.
  Together: local heads with local K/V (G % M == 0) and with gathered
  K/V (G < M), gathered Q (H = 4 on M = 8), tied and untied heads,
  `loss_chunk` on and off. The int8 wire (gemma on (2, 4), minitron on
  (4, 2), K = 4) against the JAX tree round on its (2, 4) / (4, 2)
  device mesh, whose tree engine reads the same blocked wire: round 1
  from the JAX state after round 0. Two frameworks' deltas a last bit
  apart can round one int8 step apart, so an element past 1e-5 is
  allowed one step of each client's row times its weight (bounded by
  the row's absmax / 127, from the JAX side), and such elements are
  counted and held to one in 10^4.
* **Against today's port.** The tensor-parallel 2D round (flat_sharded
  and tree) against the whole-model 2D round at 1e-5 on f32; on int8
  both engines of both kinds aggregate the same pinned deltas (the
  whole-model ones, cut to blocks for the tensor-parallel round), at
  1e-5.
* **Sharding.** Every rank ends with the same gathered params and
  metrics, bit for bit; no all_gather outside the "tp" scope is as
  large as the smallest model-sharded block; each rank's params and
  prev_delta leaves have their `NamedSpec(mesh, spec).shard_shape`.
* **Refusals**, in this process: NotImplementedError naming item 13d
  for a family it leaves out (RWKV-6: the step builder and the model),
  and for buffered rounds, a quantized downlink and FedProx's sequential
  round with `param_specs`.

The launcher off the host mesh runs on a second gloo world of 2 CPU
ranks: its losses equal the host-mesh launcher's at 1e-5, a resumed run
is bit for bit the uninterrupted one, and its checkpoint restores on
the host mesh with an equal `params_sha256`. Torch runs one intra-op
thread a rank: several sum in an order that changes between processes.
"""
import dataclasses
import os
import shutil
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
MESHES = {"2x4": (2, 4), "4x2": (4, 2), "1x8": (1, 8)}
TOL = 1e-5
JOIN_TIMEOUT = 600  # seconds for the gloo world and the JAX subprocess
T, GLOBAL_B, TAU, ROUNDS = 64, 4, 1, 2
LM_PRESET = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                 d_ff=1024, vocab_size=512)
# config -> (its changes, the port's attention_impl)
ARCHS = {
    "gemma-2b": ({}, "xla"),
    "granite-20b": ({"loss_chunk": 24}, "xla"),
    "minitron-4b": ({}, "flash"),
    "starcoder2-15b": ({}, "xla"),
    "lm": ({"loss_chunk": 24}, "flash"),
    "deepseek-v2-lite-16b": ({}, "xla"),
}
STEP_CASES = [(a, m) for a in ARCHS for m in MESHES]
# build_train_step(angle_filter="dense_only"): the angles over the
# params outside the routed experts
DENSE_ONLY_CASES = [("deepseek-v2-lite-16b", "2x4")]
SEED_ORDER = sorted(a for a in ARCHS if not a.startswith("deepseek")) + [
    "deepseek-v2-lite-16b"]
INT8_CASES = {"gemma-2b": "2x4", "minitron-4b": "4x2"}
INT8_K, INT8_TAU = 4, 2
WHOLE_CASES = [("gemma-2b", "2x4"), ("starcoder2-15b", "4x2"),
               ("gemma-2b", "1x8")]
WHOLE_K, WHOLE_TAU = 4, 2
FLIP_SHARE = 1e-4  # int8 elements past 1e-5, at most this share
METRIC_KEYS = ("loss", "theta", "weights", "divergence")


def cfg_fields(k, tau, **kw):
    return dict(num_clients=k, clients_per_round=k, local_steps=tau, **kw)


def client_count(mname):
    return MESHES[mname][0]


def tokens(seed, r, k, tau, b, vocab):
    rng = np.random.default_rng(1000 * seed + r)
    return rng.integers(0, vocab, (k, tau, b, T)).astype(np.int32)


def case_seed(arch, mname):
    return SEED_ORDER.index(arch) * 10 + sorted(MESHES).index(mname)


def angle0(k):
    return (np.linspace(0.2, 1.0, k).astype(np.float32),
            (np.arange(k) % 3).astype(np.int32))


def sizes_of(k):
    return (10.0 * (1.0 + np.arange(k))).astype(np.float32)


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


def _flat_paths(prefix, tree, keys=()):
    """{prefix/path: leaf} over a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_paths(prefix, tree[k], keys + (k,)))
        return out
    return {prefix + "/" + "/".join(keys): np.asarray(tree)}


def _nested(flat, prefix):
    """The nested dict saved by `_flat_paths(prefix, ...)`."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ------------------------------------------------------------ the JAX side


def _jax_cfg(arch):
    from repro.configs import registry as jregistry
    from repro.models.config import ModelConfig

    changes, _ = ARCHS[arch]
    if arch == "lm":
        cfg = ModelConfig(name="fl-lm-tp", arch_type="dense",
                          tie_embeddings=True, dtype="float32", **LM_PRESET)
    else:
        cfg = jregistry.smoke(arch)
    return dataclasses.replace(cfg, **changes)


def jax_main(out_dir):
    """The reference's rounds: the unsharded tree round per (config, K),
    and the int8 tree round on a device mesh; params first."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.core import fl as jfl
    from repro.core import treemath as jtm
    from repro.core.weighting import AngleState
    from repro.models import transformer as jtr

    enter = getattr(jax.sharding, "use_mesh", None) or jax.set_mesh
    inits = {}
    for arch in ARCHS:
        inits[arch] = jax.tree.map(np.asarray, jtr.init_params(
            jax.random.key(0), _jax_cfg(arch)))
    _save(os.path.join(out_dir, "params.npz"), {
        k: v for arch, tree in inits.items()
        for k, v in _flat_paths(arch, tree).items()})

    def run(arch, k, tau, seed, rounds, mesh=None, transport="f32",
            prefix="", angle_pred=None):
        jcfg = _jax_cfg(arch)
        # the step builder's config; the int8 rounds at a larger lr
        fc = jfl.FLConfig(**cfg_fields(k, tau, transport=transport,
                                       base_lr=0.01 if mesh is None
                                       else 0.05))
        rf = jax.jit(jfl.make_round_fn(
            lambda p, bt: jtr.loss_fn(p, jcfg, bt), fc, None, angle_pred,
            mesh=mesh))
        st = jfl.init_round_state(fc, jax.tree.map(jnp.asarray,
                                                   inits[arch]))
        sm0, cnt0 = angle0(k)
        st = st._replace(angle=AngleState(jnp.asarray(sm0),
                                          jnp.asarray(cnt0)))
        b = GLOBAL_B // k if tau == TAU else 2
        res = {}
        for r in range(rounds):
            toks = tokens(seed, r, k, tau, b, jcfg.vocab_size)
            if transport != "f32":
                # each client's largest |delta|: its largest wire step is
                # at most that / 127
                lr = float(jfl._lr_at(fc, r))
                d, _ = jax.jit(jax.vmap(lambda bt: jfl.local_update(
                    lambda p, x: jtr.loss_fn(p, jcfg, x), st.params, bt,
                    lr)))({"tokens": jnp.asarray(toks)})
                res[f"{prefix}/r{r}/absmax"] = np.asarray(
                    jnp.max(jnp.abs(jtm.tree_ravel_stacked(d)[0]), axis=1))
                res.update(_flat_paths(f"{prefix}/r{r}/start/params",
                                       jax.tree.map(np.asarray, st.params)))
                res.update(_flat_paths(
                    f"{prefix}/r{r}/start/prev_delta",
                    jax.tree.map(np.asarray, st.prev_delta)))
                res[f"{prefix}/r{r}/start/angle"] = np.asarray(
                    st.angle.smoothed)
                res[f"{prefix}/r{r}/start/count"] = np.asarray(
                    st.angle.count)
            st, m = rf(st, {"tokens": jnp.asarray(toks)},
                       jnp.arange(k, dtype=jnp.int32),
                       jnp.asarray(sizes_of(k)))
            res[f"{prefix}/r{r}/params"] = np.asarray(
                jtm.tree_ravel(st.params)[0])
            res[f"{prefix}/r{r}/prev_delta"] = np.asarray(
                jtm.tree_ravel(st.prev_delta)[0])
            res[f"{prefix}/r{r}/angle"] = np.asarray(st.angle.smoothed)
            res[f"{prefix}/r{r}/count"] = np.asarray(st.angle.count)
            for key in METRIC_KEYS:
                res[f"{prefix}/r{r}/m/{key}"] = np.asarray(m[key])
        return res

    res = {}
    for arch, mname in STEP_CASES:
        res.update(run(arch, client_count(mname), TAU,
                       case_seed(arch, mname), ROUNDS,
                       prefix=f"step/{arch}/{mname}"))
    for arch, mname in DENSE_ONLY_CASES:
        res.update(run(arch, client_count(mname), TAU,
                       case_seed(arch, mname) + 5, ROUNDS,
                       prefix=f"dense_only/{arch}/{mname}",
                       angle_pred=jfl.moe_dense_only_pred))
    for arch, mname in INT8_CASES.items():
        mesh = jax.make_mesh(MESHES[mname], ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        with enter(mesh):
            res.update(run(arch, INT8_K, INT8_TAU, case_seed(arch, mname),
                           ROUNDS, mesh=mesh, transport="int8",
                           prefix=f"int8/{arch}/{mname}"))
    _save(os.path.join(out_dir, "jax.npz"), res)


# ----------------------------------------------------------- the port side


def port_cfg(arch):
    from repro_torch.configs import registry
    from repro_torch.models.config import ModelConfig

    changes, impl = ARCHS[arch]
    if arch == "lm":
        cfg = ModelConfig(name="fl-lm-tp", arch_type="dense",
                          tie_embeddings=True, dtype="float32", **LM_PRESET)
    else:
        cfg = registry.smoke(arch)
    return dataclasses.replace(cfg, attention_impl=impl, **changes)


def _ravel(tree):
    from repro_torch.core import treemath

    return treemath.tree_ravel(tree)[0].detach().numpy()


def _state_of(st, mesh, specs, prefix):
    """What a round leaves, gathered: {prefix/key: array}."""
    from repro_torch.models import sharding

    return {f"{prefix}/params": _ravel(sharding.gather_params(
                st.params, mesh, specs)),
            f"{prefix}/prev_delta": _ravel(sharding.gather_params(
                st.prev_delta, mesh, specs)),
            f"{prefix}/angle": st.angle.smoothed.numpy(),
            f"{prefix}/count": st.angle.count.numpy()}


def _sharding_facts(st, mesh, specs, log, prefix, k):
    """Whether every state leaf has its shard shape, and the largest
    all_gather outside "tp" against the smallest model-sharded block and
    against this rank's column slices of every replicated leaf for its
    `k` clients' rows (at most what the 2D region re-joins)."""
    from repro_torch.core import fl_shard_map, treemath
    from repro_torch.models.sharding import NamedSpec

    leaves = treemath.tree_leaves(st.params) + treemath.tree_leaves(
        st.prev_delta)
    spec_leaves = 2 * treemath.tree_leaves_like(st.params, specs)
    ok = True
    blocks = []
    for x, spec in zip(leaves, spec_leaves):
        n = NamedSpec(mesh, spec)
        whole = list(x.shape)
        if "model" in spec:
            whole[spec.index("model")] *= mesh.model_size
            blocks.append(x.numel() * x.element_size())
        ok &= tuple(x.shape) == n.shard_shape(tuple(whole))
    gathers = [c.nbytes for c in log if c.op == "all_gather"
               and c.scope != "tp"]
    # a replicated leaf's column slice: ceil(size / M) (the blocked
    # layout), for every client's row (the tree engine holds them all)
    rows = fl_shard_map.padded_k(k, mesh.client_size)
    replicated = rows * 4 * sum(
        -(-x.numel() // mesh.model_size) for x, spec in zip(
            treemath.tree_leaves(st.params),
            treemath.tree_leaves_like(st.params, specs))
        if "model" not in spec)
    return {f"{prefix}/shard_shapes_ok": np.asarray(ok),
            f"{prefix}/replicated_share": np.asarray(replicated),
            f"{prefix}/largest_gather": np.asarray(max(gathers, default=0)),
            f"{prefix}/smallest_block": np.asarray(min(blocks)),
            f"{prefix}/tp_collectives": np.asarray(
                sum(c.scope == "tp" for c in log))}


def _port_step(arch, mname, mesh, params_np, angle_filter="all"):
    """`build_train_step`'s fn on `mesh` from the JAX init, 2 rounds."""
    from repro_torch import convert
    from repro_torch.configs import shapes
    from repro_torch.core import fl as tfl
    from repro_torch.launch import steps
    from repro_torch.models import sharding

    cfg = port_cfg(arch)
    fn, args, _, _, meta = steps.build_train_step(
        cfg, mesh, shapes.InputShape("train_4k", T, GLOBAL_B, "train"),
        angle_filter=angle_filter)
    k, b = meta["K"], meta["B"]
    assert k == client_count(mname) and meta["tau"] == TAU
    fc = tfl.FLConfig(**meta["flcfg"])
    assert fc == tfl.FLConfig(**cfg_fields(k, TAU, engine="flat_sharded"))
    specs = sharding.param_pspecs(args[0].params, mesh)
    sm0, cnt0 = angle0(k)
    st = convert.round_state_from_numpy(fc, params_np, sm0, cnt0,
                                        device="cpu")
    st = st._replace(params=sharding.shard_params(st.params, mesh, specs),
                     prev_delta=sharding.shard_params(st.prev_delta, mesh,
                                                      specs))
    dense_only = angle_filter == "dense_only"
    prefix = f"{'dense_only' if dense_only else 'step'}/{arch}/{mname}"
    seed = case_seed(arch, mname) + (5 if dense_only else 0)
    res = {}
    for r in range(ROUNDS):
        toks = tokens(seed, r, k, TAU, b, cfg.vocab_size)
        with mesh.recording() as log:
            st, m = fn(st, {"tokens": torch.from_numpy(toks)},
                       torch.arange(k, dtype=torch.int32),
                       torch.from_numpy(sizes_of(k)))
        res.update(_state_of(st, mesh, specs, f"{prefix}/r{r}"))
        res.update({f"{prefix}/r{r}/m/{key}": m[key].detach().numpy()
                    for key in METRIC_KEYS})
        res.update(_sharding_facts(st, mesh, specs, log, f"{prefix}/r{r}",
                                   k))
    return res


def _loss(cfg):
    from repro_torch.models import transformer

    return lambda p, bt: transformer.loss_fn(p, cfg, bt)


def _port_int8(arch, mname, mesh, jx):
    """The int8 tensor-parallel round (flat_sharded), each round from the
    JAX state it starts from."""
    from repro_torch import convert
    from repro_torch.core import fl as tfl
    from repro_torch.models import sharding

    cfg = port_cfg(arch)
    fc = tfl.FLConfig(engine="flat_sharded",
                      **cfg_fields(INT8_K, INT8_TAU, transport="int8",
                                   base_lr=0.05))
    prefix = f"int8/{arch}/{mname}"
    res = {}
    for r in range(ROUNDS):
        start = f"{prefix}/r{r}/start"
        params = _nested(jx, f"{start}/params")
        st = convert.round_state_from_numpy(
            fc, params, jx[f"{start}/angle"], jx[f"{start}/count"],
            round=r, device="cpu",
            prev_delta=_nested(jx, f"{start}/prev_delta"))
        specs = sharding.param_pspecs(st.params, mesh)
        rf = tfl.make_round_fn(_loss(cfg), fc, mesh=mesh, param_specs=specs)
        st = st._replace(params=sharding.shard_params(st.params, mesh, specs),
                         prev_delta=sharding.shard_params(st.prev_delta,
                                                          mesh, specs))
        toks = tokens(case_seed(arch, mname), r, INT8_K, INT8_TAU, 2,
                      cfg.vocab_size)
        st, m = rf(st, {"tokens": torch.from_numpy(toks)},
                   torch.arange(INT8_K), torch.from_numpy(sizes_of(INT8_K)))
        res.update(_state_of(st, mesh, specs, f"{prefix}/r{r}"))
        res.update({f"{prefix}/r{r}/m/{key}": m[key].detach().numpy()
                    for key in METRIC_KEYS})
    return res


def _port_whole(arch, mname, mesh, params_np):
    """The tensor-parallel 2D round against the whole-model 2D round,
    one round from the same state, per engine: f32 on each one's own
    training; int8 on pinned deltas."""
    from repro_torch import convert
    from repro_torch.core import fl as tfl
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.core import treemath
    from repro_torch.models import sharding

    cfg = port_cfg(arch)
    k = WHOLE_K
    toks = {"tokens": torch.from_numpy(tokens(
        case_seed(arch, mname) + 500, 0, k, WHOLE_TAU, 2, cfg.vocab_size))}
    sel, sizes = torch.arange(k), torch.from_numpy(sizes_of(k))
    sm0, cnt0 = angle0(k)
    res = {}
    for wire in ("f32", "int8"):
        base = tfl.FLConfig(**cfg_fields(k, WHOLE_TAU, transport=wire,
                                         base_lr=0.05))
        st = convert.round_state_from_numpy(base, params_np, sm0, cnt0,
                                            device="cpu")
        specs = sharding.param_pspecs(st.params, mesh)
        pin = None
        if wire != "f32":
            ref, _ = tfl._clients(_loss(cfg), base, None, None)(
                st.params, toks, tfl._lr_at(base, 0))
            rows = tsm.flat_client_sharding(mesh).rows(k)

            def pin(deltas, ref=ref, rows=rows):
                """The whole-model clients' deltas: this rank's rows or
                all, whole or cut to this rank's blocks."""
                full = deltas["embed"].shape[0] == k
                out = ref if full else treemath.tree_map(
                    lambda v: v[rows], ref)
                if tuple(deltas["embed"].shape[1:]) != tuple(
                        out["embed"].shape[1:]):
                    out = tsm.local_blocks(mesh, out, specs)
                return out
        blocks = st._replace(
            params=sharding.shard_params(st.params, mesh, specs),
            prev_delta=sharding.shard_params(st.prev_delta, mesh, specs))
        for engine in ("flat_sharded", "tree"):
            fc = dataclasses.replace(base, engine=engine)
            whole, wm = tfl.make_round_fn(_loss(cfg), fc, pin, mesh=mesh)(
                st, toks, sel, sizes)
            with mesh.recording() as log:
                tp_st, tm = tfl.make_round_fn(
                    _loss(cfg), fc, pin, mesh=mesh, param_specs=specs)(
                    blocks, toks, sel, sizes)
            prefix = f"whole/{arch}/{mname}/{wire}/{engine}"
            res[f"{prefix}/whole/params"] = _ravel(whole.params)
            res[f"{prefix}/whole/prev_delta"] = _ravel(whole.prev_delta)
            res.update({f"{prefix}/whole/m/{key}": wm[key].detach().numpy()
                        for key in METRIC_KEYS})
            res.update(_state_of(tp_st, mesh, specs, f"{prefix}/tp"))
            res.update({f"{prefix}/tp/m/{key}": tm[key].detach().numpy()
                        for key in METRIC_KEYS})
            res.update(_sharding_facts(tp_st, mesh, specs, log,
                                       f"{prefix}/tp", k))
    return res


def _port_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_client_mesh

        meshes = {name: make_client_mesh(device="cpu", model=shape[1])
                  for name, shape in MESHES.items()}
        inits = _load_when_written(os.path.join(out_dir, "params.npz"))
        res = {}
        for arch, mname in STEP_CASES:
            res.update(_port_step(arch, mname, meshes[mname],
                                  _nested(inits, arch)))
        for arch, mname in DENSE_ONLY_CASES:
            res.update(_port_step(arch, mname, meshes[mname],
                                  _nested(inits, arch), "dense_only"))
        for arch, mname in WHOLE_CASES:
            res.update(_port_whole(arch, mname, meshes[mname],
                                   _nested(inits, arch)))
        jx = _load_when_written(os.path.join(out_dir, "jax.npz"))
        for arch, mname in INT8_CASES.items():
            res.update(_port_int8(arch, mname, meshes[mname], jx))
        np.savez(os.path.join(out_dir, f"port_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _start_jax(out_dir):
    prog = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "import test_torch_tp as t; "
            f"t.jax_main({out_dir!r})")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _run_world(worker, nprocs, args):
    ctx = mp.start_processes(worker, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError("the gloo world did not finish in "
                                     f"{JOIN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return deadline


@pytest.fixture(scope="module")
def worlds():
    """(each rank's results, the JAX results)."""
    with tempfile.TemporaryDirectory() as out_dir:
        jax_proc = _start_jax(out_dir)
        try:
            deadline = _run_world(_port_worker, WORLD, (
                os.path.join(out_dir, "store"), out_dir))
            _, err = jax_proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if jax_proc.poll() is None:
                jax_proc.kill()
        assert jax_proc.returncode == 0, err[-3000:]
        port = [dict(np.load(os.path.join(out_dir, f"port_rank{r}.npz")))
                for r in range(WORLD)]
        jx = dict(np.load(os.path.join(out_dir, "jax.npz")))
    return port, jx


def _close(got, want, msg, allow=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > TOL + TOL * np.abs(want) + allow
    assert not bad.any(), (f"{msg}: {int(bad.sum())} of {bad.size} off, "
                           f"worst {np.max(np.abs(got - want))}")


# -------------------------------------------------------------- the tests


@pytest.mark.parametrize("kind,arch,mname", [
    ("step", a, m) for a, m in STEP_CASES] + [
    ("dense_only", a, m) for a, m in DENSE_ONLY_CASES])
def test_tp_train_step_matches_the_jax_round(worlds, kind, arch, mname):
    port, jx = worlds
    p = port[0]
    for r in range(ROUNDS):
        prefix = f"{kind}/{arch}/{mname}/r{r}"
        for key in ("params", "prev_delta", "angle"):
            _close(p[f"{prefix}/{key}"], jx[f"{prefix}/{key}"],
                   f"{prefix} {key}")
        assert np.array_equal(p[f"{prefix}/count"], jx[f"{prefix}/count"])
        for key in METRIC_KEYS:
            _close(p[f"{prefix}/m/{key}"], jx[f"{prefix}/m/{key}"],
                   f"{prefix} {key}")


@pytest.mark.parametrize("arch", list(INT8_CASES))
def test_tp_int8_round_matches_the_jax_2d_round(worlds, arch):
    port, jx = worlds
    p = port[0]
    mname = INT8_CASES[arch]
    for r in range(ROUNDS):
        prefix = f"int8/{arch}/{mname}/r{r}"
        # one wire step a client at most, at its aggregation weight
        step = jx[f"{prefix}/absmax"].astype(np.float64) / 127.0
        w = jx[f"{prefix}/m/weights"].astype(np.float64)
        psi = sizes_of(INT8_K) / sizes_of(INT8_K).sum()
        for key, weights in (("params", w), ("prev_delta", psi)):
            got, want = p[f"{prefix}/{key}"], jx[f"{prefix}/{key}"]
            _close(got, want, f"{prefix} {key}",
                   allow=float(np.dot(weights, step)))
            flips = np.abs(got.astype(np.float64) - want) > \
                TOL + TOL * np.abs(want)
            assert flips.sum() <= FLIP_SHARE * flips.size, (
                f"{prefix} {key}: {int(flips.sum())} elements a step off")
        _close(p[f"{prefix}/angle"], jx[f"{prefix}/angle"], prefix)
        for key in METRIC_KEYS:
            _close(p[f"{prefix}/m/{key}"], jx[f"{prefix}/m/{key}"],
                   f"{prefix} {key}")


@pytest.mark.parametrize("engine", ["flat_sharded", "tree"])
@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("arch,mname", WHOLE_CASES)
def test_tp_round_matches_the_whole_model_round(worlds, arch, mname, wire,
                                                engine):
    port, _ = worlds
    p = port[0]
    prefix = f"whole/{arch}/{mname}/{wire}/{engine}"
    for key in ("params", "prev_delta") + tuple(
            f"m/{k}" for k in METRIC_KEYS):
        _close(p[f"{prefix}/tp/{key}"], p[f"{prefix}/whole/{key}"],
               f"{prefix} {key}")


@pytest.mark.parametrize("group", [
    f"step/{a}/{m}" for a, m in STEP_CASES] + [
    f"dense_only/{a}/{m}" for a, m in DENSE_ONLY_CASES] + [
    f"whole/{a}/{m}" for a, m in WHOLE_CASES] + [
    f"int8/{a}/{m}" for a, m in INT8_CASES.items()])
def test_ranks_agree_bit_for_bit(worlds, group):
    port, _ = worlds
    keys = [k for k in port[0] if k.startswith(group + "/")]
    assert keys, group
    for key in keys:
        for r in range(1, WORLD):
            assert np.array_equal(port[r][key], port[0][key],
                                  equal_nan=True), f"rank {r} {key}"


@pytest.mark.parametrize("group", [
    f"step/{a}/{m}/r{r}" for a, m in STEP_CASES for r in range(ROUNDS)] + [
    f"dense_only/{a}/{m}/r{r}" for a, m in DENSE_ONLY_CASES
    for r in range(ROUNDS)] + [
    f"whole/{a}/{m}/{w}/{e}/tp" for a, m in WHOLE_CASES
    for w in ("f32", "int8") for e in ("flat_sharded", "tree")])
def test_state_stays_in_blocks(worlds, group):
    """Each rank's params and prev_delta leaves have their shard shapes;
    the client training ran its collectives under "tp"; every other
    all_gather is at most the clients' column slices of the replicated
    leaves (the region re-joins only those), and for the dense configs,
    whose replicated leaves are the norms, smaller than the smallest
    model-sharded block. DeepSeek replicates `wkv_a` and the router,
    which are larger than its smallest block."""
    port, _ = worlds
    for r, p in enumerate(port):
        assert p[f"{group}/shard_shapes_ok"], f"rank {r} {group}"
        assert p[f"{group}/tp_collectives"] > 0, group
        largest = p[f"{group}/largest_gather"]
        assert largest <= p[f"{group}/replicated_share"], (
            f"rank {r} {group}: an all_gather of {largest} B outside 'tp'")
        if "/deepseek" not in group:
            assert largest < p[f"{group}/smallest_block"], (
                f"rank {r} {group}: an all_gather of {largest} B outside "
                "'tp'")


# ------------------------------------------------ refusals, in this process


def _fake_2d_mesh():
    """A (2, 2) ClientMesh whose groups are never used: all that the
    builders read of a mesh before any collective."""
    from repro_torch.launch.mesh import ClientMesh

    g = object()
    return ClientMesh(group=g, rank=0, size=4, device=torch.device("cpu"),
                      model=2, data_group=g, model_group=g)


def test_a_moe_config_names_item_13d():
    """A family item 13d still leaves out (RWKV-6; the MoE and MLA of
    the DeepSeek family now train tensor-parallel): the step builder and
    the model refuse it."""
    from repro_torch.configs import registry, shapes
    from repro_torch.launch import steps
    from repro_torch.models import tp, transformer

    cfg = registry.smoke("rwkv6-3b")
    mesh = _fake_2d_mesh()
    with pytest.raises(NotImplementedError, match="item 13d"):
        steps.build_train_step(cfg, mesh,
                               shapes.InputShape("train_4k", T, 4, "train"))
    params = transformer.init_params(None, cfg, device="meta")
    batch = {"tokens": torch.zeros((2, T), dtype=torch.int32,
                                   device="meta")}
    with tp.scope(mesh), pytest.raises(NotImplementedError,
                                       match="item 13d"):
        transformer.loss_fn(params, cfg, batch)


@pytest.mark.parametrize("change", [
    dict(mode="sequential", method="fedprox", prox_mu=0.1),
    dict(aggregation="buffered"), dict(downlink="int8")])
def test_other_rounds_with_param_specs_name_item_13d(change):
    """The rounds that cannot keep their params in blocks refuse
    param_specs: buffered, a quantized downlink, and FedProx's
    sequential round (its proximal term over blocks; the FSDP sequential
    round itself runs, `tests/test_torch_fsdp.py`)."""
    from repro_torch.core import fl as tfl

    engine = "tree" if change.get("mode") == "sequential" else "flat_sharded"
    cfg = tfl.FLConfig(**cfg_fields(4, 1, engine=engine, **change))
    with pytest.raises(NotImplementedError, match="item 13d"):
        tfl.make_round_fn(_loss(port_cfg("gemma-2b")), cfg,
                          mesh=_fake_2d_mesh(), param_specs={})


def test_param_specs_need_a_mesh_engine():
    from repro_torch.core import fl as tfl

    for engine, mesh in (("flat", _fake_2d_mesh()), ("tree", None)):
        cfg = tfl.FLConfig(**cfg_fields(4, 1, engine=engine))
        with pytest.raises(ValueError, match="param_specs places"):
            tfl.make_round_fn(_loss(port_cfg("gemma-2b")), cfg, mesh=mesh,
                              param_specs={})


def test_operators_are_identities_outside_a_scope():
    """Outside a scope, and on a model axis of one rank, every operator
    returns its input and nothing is gathered."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import tp

    x = torch.randn(3, 4)
    for ctx in (None, make_host_mesh("cpu")):
        if ctx is None:
            got = [tp.copy_to_model(x), tp.reduce_from_model(x),
                   tp.gather_from_model(x, -1), tp.max_over_model(x)]
            assert tp.active() is None
        else:
            with tp.scope(ctx):
                assert tp.active() is None and tp.model_size() == 1
                got = [tp.copy_to_model(x), tp.reduce_from_model(x),
                       tp.gather_from_model(x, -1), tp.max_over_model(x)]
        for g in got:
            assert torch.equal(g, x)


# ------------------------------------------------ the launcher on 2 ranks

LAUNCH = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--seq",
          "32", "--global-batch", "2"]


def _launch_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=2)
    try:
        from repro_torch.launch import train

        ckpt, whole_ckpt = (os.path.join(out_dir, d)
                            for d in ("ckpt", "whole"))
        whole = train.main(LAUNCH + ["--rounds", "3", "--ckpt", whole_ckpt])
        half = train.main(LAUNCH + ["--rounds", "2", "--ckpt", ckpt])
        resumed = train.main(LAUNCH + ["--rounds", "3", "--ckpt", ckpt,
                                       "--resume"])
        np.savez(os.path.join(out_dir, f"launch_rank{rank}.npz"),
                 whole_losses=np.asarray(whole["losses"]),
                 half_losses=np.asarray(half["losses"]),
                 resumed_losses=np.asarray(resumed["losses"]),
                 whole_sha=np.asarray(whole["params_sha256"]),
                 resumed_sha=np.asarray(resumed["params_sha256"]),
                 resumed_start=np.asarray(resumed["start_round"]),
                 engine=np.asarray(whole["meta"]["flcfg"]["engine"]))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def launcher_world():
    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as out_dir:
        _run_world(_launch_worker, 2, (os.path.join(out_dir, "store"),
                                       out_dir))
        ranks = [dict(np.load(os.path.join(out_dir, f"launch_rank{r}.npz")))
                 for r in range(2)]
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            host = train.main(LAUNCH + ["--rounds", "3", "--host-mesh"])
            # the tensor-parallel run's checkpoint on the host mesh
            restored = train.main(LAUNCH + [
                "--rounds", "3", "--host-mesh", "--resume", "--ckpt",
                shutil.copytree(os.path.join(out_dir, "whole"),
                                os.path.join(out_dir, "restored"))])
        finally:
            torch.set_num_threads(n)
    return ranks, host, restored


def test_launcher_off_the_host_mesh_matches_the_host_mesh(launcher_world):
    ranks, host, _ = launcher_world
    for r in ranks:
        np.testing.assert_allclose(r["whole_losses"], host["losses"],
                                   rtol=TOL, atol=TOL)
        assert str(r["engine"]) == "flat_sharded"


def test_launcher_off_the_host_mesh_resumes_bit_for_bit(launcher_world):
    ranks, _, _ = launcher_world
    for r in ranks:
        assert int(r["resumed_start"]) == 2
        assert np.array_equal(r["half_losses"], r["whole_losses"][:2])
        assert np.array_equal(r["resumed_losses"], r["whole_losses"][2:])
        assert str(r["resumed_sha"]) == str(r["whole_sha"])
    assert str(ranks[0]["whole_sha"]) == str(ranks[1]["whole_sha"])


def test_tp_checkpoint_restores_on_the_host_mesh(launcher_world):
    ranks, _, restored = launcher_world
    assert restored["start_round"] == 3 and restored["losses"] == []
    assert restored["params_sha256"] == str(ranks[0]["whole_sha"])
