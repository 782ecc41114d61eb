"""FSDP over the mesh's "data" axis (`sharding.param_pspecs(...,
fsdp=True)`, the "data" gathers of `models/tp.py`) on one gloo world of
CPU ranks, against the JAX package.

One gloo world of 8 CPU ranks (`torch.multiprocessing` spawn, `file://`
store) builds an (8, 1), a (2, 4), a (4, 2) and a (1, 8) ("data",
"model") mesh; one JAX subprocess writes its init of each config first,
then its unsharded results. Both sides draw the same numpy inputs from
seeds; the port starts from the JAX init, cut to each rank's blocks on
both axes. Held at 1e-5:

* **The sequential (FSDP) round.** `build_train_step(...,
  fl_mode="sequential")`'s fn (K = 16 clients, B = 2 rows each, T = 64)
  on this rank's blocks and this data index's rows, against the JAX
  package's sequential round (`make_round_fn(..., FLConfig(mode=
  "sequential"))`) jitted on the whole model: params, prev_delta, the
  smoothed angles, loss, theta, weights, divergence. The smoke configs
  of gemma-2b on every mesh (B = 2 splits over 2 data ranks and is
  replicated over 4 and 8), minitron-4b and deepseek-v2-lite-16b
  (MLA + MoE); `stale_angles`, fedavg and `angle_filter="dense_only"`
  cases.
* **Serving.** `build_prefill_step` / `build_decode_step` with
  `fsdp=True`: the prefill's last logits and 3 decode steps' logits
  against the JAX package's unsharded `forward(mode="prefill")` and
  `decode_step`, for gemma-2b at B = 4 and at B = 1 (the cache's
  sequence on "data", its block edge at position 65, which the decode
  steps cross), gemma-2b with a sliding window of 24 at B = 1 (the
  ring wraps, and its slots cross the ranks' blocks), and
  deepseek-v2-lite-16b at B = 4 and B = 1 (the MLA latents on "data").

Also held: the ranks bit for bit (every rank's round; the ranks of a
data index's logits); every param, prev_delta and cache leaf of its
`shard_shape`; the round's "fsdp" collectives' count and bytes against
a count from the shapes; `ClientMesh.reduce_scatter` against
`all_gather` followed by a slice; and, on a gloo world of 2 ranks whose
launcher mesh is (2, 1), `python -m repro_torch.launch.serve --smoke
--shape long_500k --steps 3` emits the host-mesh launcher's tokens.
In this process: a parallel round given FSDP specs refuses, naming
item 13d. Torch runs one intra-op thread a rank.
"""
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_tp as tpt  # noqa: E402  (the world helpers)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 8
MESHES = {"8x1": (8, 1), "2x4": (2, 4), "4x2": (4, 2), "1x8": (1, 8)}
TOL = 1e-5
T = 64
K = 16  # the step builder's clients a sequential round
GLOBAL_B = 2 * K  # B = 2 rows a client: split over 2 data ranks only
ARCHS = ("gemma-2b", "minitron-4b", "deepseek-v2-lite-16b")
# case -> (config, mesh, build_train_step keywords)
# (the rows split over "data" on 2x4, are replicated on 8x1 and 4x2;
# 1x8 has no data axis)
ROUND_CASES = {
    "gemma-2b/2x4": ("gemma-2b", "2x4", {}),
    "gemma-2b/8x1": ("gemma-2b", "8x1", {}),
    "gemma-2b/1x8": ("gemma-2b", "1x8", {}),
    "gemma-2b/2x4/stale": ("gemma-2b", "2x4", {"stale": True}),
    "minitron-4b/4x2/fedavg": ("minitron-4b", "4x2", {"method": "fedavg"}),
    "deepseek-v2-lite-16b/2x4/dense_only": (
        "deepseek-v2-lite-16b", "2x4", {"angle_filter": "dense_only"}),
}
METRIC_KEYS = ("loss", "theta", "weights", "divergence")
# serving: case -> (config, its changes, B)
SERVE_CASES = {
    "gemma-2b/B4": ("gemma-2b", {}, 4),
    "gemma-2b/B1": ("gemma-2b", {}, 1),
    "gemma-2b-swa/B1": ("gemma-2b", {"sliding_window": 24}, 1),
    "deepseek-v2-lite-16b/B4": ("deepseek-v2-lite-16b", {}, 4),
    "deepseek-v2-lite-16b/B1": ("deepseek-v2-lite-16b", {}, 1),
}
STEPS = 3
EDGE = 65  # a rank's positions of a cache split over "data"
SERVE_MESHES = ("8x1", "2x4", "4x2")  # every mesh with a data axis


def case_seed(case):
    return 3 + sorted(ROUND_CASES).index(case)


def arch_seed(arch):
    return 11 + ARCHS.index(arch)


def cache_len(mname):
    """The serving cache's positions on a mesh: its data ranks' blocks of
    EDGE positions (one block without a data axis)."""
    return max(MESHES[mname][0], 2) * EDGE


def round_tokens(case, vocab):
    rng = np.random.default_rng(case_seed(case))
    return rng.integers(0, vocab, (K, 1, GLOBAL_B // K, T)).astype(np.int32)


def prev_delta0(params, case):
    """A seeded prev_delta tree (f32), for the stale pass's angles."""
    rng = np.random.default_rng(100 + case_seed(case))

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(tree[k]) for k in sorted(tree)}
        return (1e-3 * rng.standard_normal(np.shape(tree))).astype(
            np.float32)

    return draw(params)


def angle0():
    return (np.linspace(0.2, 1.0, K).astype(np.float32),
            (np.arange(K) % 3).astype(np.int32))


def sizes():
    return (10.0 * (1.0 + np.arange(K))).astype(np.float32)


def serve_seed(case):
    return 50 + list(SERVE_CASES).index(case)


def prompt(case):
    _, _, b = SERVE_CASES[case]
    rng = np.random.default_rng(serve_seed(case))
    return rng.integers(0, 512, (b, T)).astype(np.int32)


def decode_tokens(case):
    _, _, b = SERVE_CASES[case]
    rng = np.random.default_rng(200 + serve_seed(case))
    return rng.integers(0, 512, (STEPS, b, 1)).astype(np.int32)


# ------------------------------------------------------------ the JAX side


def _jax_cfg(arch, changes=None):
    import dataclasses

    from repro.configs import registry as jregistry

    return dataclasses.replace(jregistry.smoke(arch), **(changes or {}))


def jax_main(out_dir):
    """The JAX init of every config first, then the sequential rounds and
    the unsharded prefill and decode steps."""
    import jax
    import jax.numpy as jnp

    from repro.core import fl as jfl
    from repro.core import treemath as jtm
    from repro.core.weighting import AngleState
    from repro.models import transformer as jtr

    inits = {arch: jax.tree.map(np.asarray, jtr.init_params(
        jax.random.key(arch_seed(arch)), _jax_cfg(arch))) for arch in ARCHS}
    tpt._save(os.path.join(out_dir, "params.npz"), {
        k: v for arch, tree in inits.items()
        for k, v in tpt._flat_paths(arch, tree).items()})
    res = {}
    for case, (arch, _, kw) in ROUND_CASES.items():
        cfg = _jax_cfg(arch)
        fc = jfl.FLConfig(num_clients=K, clients_per_round=K, local_steps=1,
                          method=kw.get("method", "fedadp"),
                          mode="sequential",
                          stale_angles=kw.get("stale", False))
        pred = (jfl.moe_dense_only_pred
                if kw.get("angle_filter") == "dense_only" else None)
        rf = jax.jit(jfl.make_round_fn(
            lambda p, bt, cfg=cfg: jtr.loss_fn(p, cfg, bt), fc, None, pred))
        st = jfl.init_round_state(fc, jax.tree.map(jnp.asarray, inits[arch]))
        sm0, cnt0 = angle0()
        st = st._replace(
            angle=AngleState(jnp.asarray(sm0), jnp.asarray(cnt0)),
            prev_delta=jax.tree.map(jnp.asarray,
                                    prev_delta0(inits[arch], case)))
        st, m = rf(st, {"tokens": jnp.asarray(round_tokens(
            case, cfg.vocab_size))}, jnp.arange(K, dtype=jnp.int32),
            jnp.asarray(sizes()))
        res[f"round/{case}/params"] = np.asarray(jtm.tree_ravel(
            st.params)[0])
        res[f"round/{case}/prev_delta"] = np.asarray(jtm.tree_ravel(
            st.prev_delta)[0])
        res[f"round/{case}/angle"] = np.asarray(st.angle.smoothed)
        res[f"round/{case}/count"] = np.asarray(st.angle.count)
        for key in METRIC_KEYS:
            res[f"round/{case}/m/{key}"] = np.asarray(m[key])
    for case, (arch, changes, _) in SERVE_CASES.items():
        cfg = _jax_cfg(arch, changes)
        params = jax.tree.map(jnp.asarray, inits[arch])
        logits, _, cache = jax.jit(lambda p, t, cfg=cfg: jtr.forward(
            p, cfg, {"tokens": t}, mode="prefill", max_len=T + STEPS + 1))(
            params, jnp.asarray(prompt(case)))
        out = [np.asarray(logits[:, -1:])]
        step = jax.jit(lambda p, tok, c, pos, cfg=cfg: jtr.decode_step(
            p, cfg, tok, c, pos))
        for i, tok in enumerate(decode_tokens(case)):
            logits, cache = step(params, jnp.asarray(tok), cache,
                                 jnp.int32(T + i))
            out.append(np.asarray(logits))
        res[f"serve/{case}"] = np.concatenate(out, axis=1)
    tpt._save(os.path.join(out_dir, "jax.npz"), res)


# ----------------------------------------------------------- the port side


def port_cfg(arch, changes=None):
    from repro_torch.configs import registry
    from repro_torch.models.config import with_changes

    return with_changes(registry.smoke(arch), changes or {})


def _shapes_ok(blocks, whole_shapes, specs, mesh) -> bool:
    from repro_torch.core import treemath
    from repro_torch.models.sharding import NamedSpec

    return all(
        tuple(x.shape) == NamedSpec(mesh, s).shard_shape(tuple(w.shape))
        for x, w, s in zip(treemath.tree_leaves(blocks),
                           treemath.tree_leaves(whole_shapes),
                           treemath.tree_leaves_like(whole_shapes, specs)))


def fsdp_collectives(shapes, specs, mesh, trainings, split) -> dict:
    """{op: (count, bytes)} of a rank's "fsdp" collectives over
    `trainings` client trainings of one local step, from the shapes: per
    training the embedding and the head gathered once and each block
    leaf with an FSDP dim twice (the forward, the group's backward
    rerun); where the rows are `split` over "data", also each of those
    leaves' gathered cotangent reduce-scattered, every leaf with no FSDP
    dim's cotangent all-reduced over "data", and the loss's token count
    and value (4 B each); replicated rows take their slice of a
    cotangent, no collective. Empty without a data axis."""
    from repro_torch.core import treemath
    from repro_torch.models import tp
    from repro_torch.models.sharding import NamedSpec

    if mesh.client_size == 1:
        return {}
    out = {"all_gather": [0, 0]}
    if split:
        out.update(reduce_scatter=[0, 0], all_reduce=[2, 8])

    def add(op, n, nbytes):
        out[op][0] += n
        out[op][1] += n * nbytes

    for path, x, spec in zip(treemath.tree_paths(shapes),
                             treemath.tree_leaves(shapes),
                             treemath.tree_leaves_like(shapes, specs)):
        groups = x.shape[0] if path[0] == "blocks" else 1
        nbytes = math.prod(NamedSpec(mesh, spec).shard_shape(
            tuple(x.shape))) * x.element_size() // groups
        if tp.data_dim(spec) >= 0:
            add("all_gather", (2 if path[0] == "blocks" else 1) * groups,
                nbytes)
            if split:
                add("reduce_scatter", groups, nbytes * mesh.client_size)
        elif split:
            add("all_reduce", groups, nbytes)
    return {op: (c * trainings, b * trainings)
            for op, (c, b) in out.items()}


def _port_round(case, mesh, params_np):
    """`build_train_step(..., fl_mode="sequential")`'s fn on `mesh` from
    the JAX init, one round on this rank's blocks and rows."""
    from repro_torch import convert
    from repro_torch.configs import shapes
    from repro_torch.core import fl as tfl
    from repro_torch.launch import steps
    from repro_torch.models import sharding

    arch, _, kw = ROUND_CASES[case]
    cfg = port_cfg(arch)
    fn, args, in_specs, _, meta = steps.build_train_step(
        cfg, mesh, shapes.InputShape("train", T, GLOBAL_B, "train"),
        fl_mode="sequential", **kw)
    assert (meta["K"], meta["B"], meta["fl_mode"]) == (K, 2, "sequential")
    fc = tfl.FLConfig(**meta["flcfg"])
    specs = sharding.param_pspecs(args[0].params, mesh, fsdp=True)
    sm0, cnt0 = angle0()
    st = convert.round_state_from_numpy(
        fc, params_np, sm0, cnt0, device="cpu",
        prev_delta=prev_delta0(params_np, case))
    st = st._replace(params=sharding.shard_params(st.params, mesh, specs),
                     prev_delta=sharding.shard_params(st.prev_delta, mesh,
                                                      specs))
    batch = steps.local_batch({"tokens": torch.from_numpy(round_tokens(
        case, cfg.vocab_size))}, in_specs[1], mesh)
    with mesh.recording() as log:
        st, m = fn(st, batch, torch.arange(K, dtype=torch.int32),
                   torch.from_numpy(sizes()))
    prefix = f"round/{case}"
    res = tpt._state_of(st, mesh, specs, prefix)
    res.update({f"{prefix}/m/{key}": m[key].detach().numpy()
                for key in METRIC_KEYS})
    res[f"{prefix}/shapes_ok"] = np.asarray(
        _shapes_ok(st.params, args[0].params, specs, mesh)
        and _shapes_ok(st.prev_delta, args[0].params, specs, mesh))
    got = {op: (sum(1 for c in log if c.scope == "fsdp" and c.op == op),
                sum(c.nbytes for c in log
                    if c.scope == "fsdp" and c.op == op))
           for op in ("all_gather", "reduce_scatter", "all_reduce")}
    want = fsdp_collectives(args[0].params, specs, mesh,
                            K * (1 if kw.get("stale") else 2),
                            steps.rows_split(mesh, meta["B"]))
    res[f"{prefix}/collectives_ok"] = np.asarray(
        {op: v for op, v in got.items() if v[0]} == want)
    # each client's (3,) statistics summed over the mesh: one all-reduce
    # over both axes a client of pass 2
    res[f"{prefix}/stats_reduces"] = np.asarray(sum(
        1 for c in log if c.scope is None and c.axes == ("data", "model")
        and c.shape == (3,)))
    return res


def _port_serve(case, mname, mesh, params_np):
    """Prefill and 3 decode steps with fsdp=True through the step
    builders' fns on this rank's blocks and rows."""
    from repro_torch import convert
    from repro_torch.configs import shapes
    from repro_torch.launch import steps
    from repro_torch.models import sharding, transformer

    arch, changes, b = SERVE_CASES[case]
    cfg = port_cfg(arch, changes)
    s = cache_len(mname)
    meta_params = transformer.init_params(None, cfg, device="meta")
    specs = sharding.param_pspecs(meta_params, mesh, fsdp=True)
    params = sharding.shard_params(
        convert.lm_params_from_numpy(params_np, cfg, device="cpu"), mesh,
        specs)
    prefill, _, pin, _, _ = steps.build_prefill_step(
        cfg, mesh, shapes.InputShape("prefill", s, b, "prefill"), fsdp=True)
    decode, dargs, din, _, _ = steps.build_decode_step(
        cfg, mesh, shapes.InputShape("decode", s, b, "decode"), fsdp=True)
    cspecs = sharding.cache_pspecs(dargs[2], mesh)
    tokens = steps.local_batch({"tokens": torch.from_numpy(prompt(case))},
                               pin[1], mesh)
    out = []
    with torch.no_grad():
        logits, cache = prefill(params, tokens)
        out.append(logits)
        for tok in decode_tokens(case):
            tok = sharding.block(torch.from_numpy(tok), mesh, din[1].spec)
            logits, cache = decode(params, tok, cache, T + len(out) - 1)
            out.append(logits)
    prefix = f"serve/{case}/{mname}"
    rows = sharding.block(torch.arange(b)[:, None], mesh,
                          pin[1]["tokens"].spec)[:, 0]
    return {f"{prefix}/logits": torch.cat(out, dim=1).numpy(),
            f"{prefix}/rows": rows.numpy(),
            f"{prefix}/shapes_ok": np.asarray(
                _shapes_ok(cache, dargs[2], cspecs, mesh)
                and _shapes_ok(params, meta_params, specs, mesh)),
            f"{prefix}/seq_on_data": np.asarray(any(
                len(sp) > 2 and sp[2] == "data"
                for sp in _leaf_specs(cspecs)))}


def _leaf_specs(tree):
    """The spec tuples of a spec tree's part."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _leaf_specs(v)]
    return [tree]


def _reduce_scatter_check(mesh):
    """reduce_scatter == all_gather of the summed tensor's slices, over
    each axis of more than one rank and along dims 0 and 1."""
    ok = True
    for axes, n in ((("data",), mesh.client_size),
                    (("model",), mesh.model_size)):
        if n == 1:
            continue
        index = mesh.client_index if axes == ("data",) else mesh.model_index
        for dim in (0, 1):
            x = torch.arange(4 * n * 3, dtype=torch.float32).reshape(
                (4 * n, 3) if dim == 0 else (3, 4 * n)) * (1 + mesh.rank)
            got = mesh.reduce_scatter(x, axes=axes, dim=dim)
            total = mesh.all_reduce(x.clone(), axes=axes)
            want = total.narrow(dim, index * 4, 4)
            back = mesh.all_gather(got, axes=axes, dim=dim)
            ok &= torch.equal(got, want) and torch.equal(back, total)
    return ok


def _port_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_client_mesh

        meshes = {name: make_client_mesh(device="cpu", model=shape[1])
                  for name, shape in MESHES.items()}
        res = {f"reduce_scatter_ok/{name}": np.asarray(
            _reduce_scatter_check(mesh)) for name, mesh in meshes.items()}
        inits = tpt._load_when_written(os.path.join(out_dir, "params.npz"))
        for case, (arch, mname, _) in ROUND_CASES.items():
            res.update(_port_round(case, meshes[mname],
                                   tpt._nested(inits, arch)))
        for case, (arch, _, _) in SERVE_CASES.items():
            for mname in SERVE_MESHES:
                res.update(_port_serve(case, mname, meshes[mname],
                                       tpt._nested(inits, arch)))
        np.savez(os.path.join(out_dir, f"port_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _start_jax(out_dir):
    prog = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "import test_torch_fsdp as t; "
            f"t.jax_main({out_dir!r})")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def worlds():
    """(each rank's results, the JAX results)."""
    with tempfile.TemporaryDirectory() as out_dir:
        jax_proc = _start_jax(out_dir)
        try:
            deadline = tpt._run_world(_port_worker, WORLD, (
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


def _close(got, want, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    bad = np.abs(got - want) > TOL + TOL * np.abs(want)
    assert not bad.any(), (f"{msg}: {int(bad.sum())} of {bad.size} off, "
                           f"worst {np.max(np.abs(got - want))}")


# -------------------------------------------------------------- the tests


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_fsdp_sequential_round_matches_the_jax_round(worlds, case):
    port, jx = worlds
    p = port[0]
    prefix = f"round/{case}"
    for key in ("params", "prev_delta", "angle"):
        _close(p[f"{prefix}/{key}"], jx[f"{prefix}/{key}"],
               f"{prefix} {key}")
    assert np.array_equal(p[f"{prefix}/count"], jx[f"{prefix}/count"])
    for key in METRIC_KEYS:
        _close(p[f"{prefix}/m/{key}"], jx[f"{prefix}/m/{key}"],
               f"{prefix} {key}")


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_fsdp_round_ranks_agree_and_stay_in_blocks(worlds, case):
    """Every rank gathers the same params and reports the same metrics,
    bit for bit; its params and prev_delta are blocks of their shard
    shapes; its "fsdp" collectives are those of the shapes; pass 2 sums
    each client's statistics in one (3,) all-reduce over the mesh."""
    port, _ = worlds
    prefix = f"round/{case}/"
    for r, p in enumerate(port):
        assert p[prefix + "shapes_ok"], f"rank {r} {case}"
        assert p[prefix + "collectives_ok"], f"rank {r} {case}"
        assert int(p[prefix + "stats_reduces"]) == K, f"rank {r} {case}"
        for key, v in p.items():
            if key.startswith(prefix):
                assert np.array_equal(v, port[0][key], equal_nan=True), (
                    f"rank {r} {key}")


@pytest.mark.parametrize("mname", SERVE_MESHES)
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_fsdp_prefill_and_decode_match_the_jax_model(worlds, case, mname):
    port, jx = worlds
    prefix = f"serve/{case}/{mname}"
    for r, p in enumerate(port):
        rows = p[f"{prefix}/rows"]
        _close(p[f"{prefix}/logits"], jx[f"serve/{case}"][rows],
               f"rank {r} {prefix}")
        assert p[f"{prefix}/shapes_ok"], f"rank {r} {prefix}"
        # a batch that does not split over "data" puts the cache's
        # sequence there
        b = SERVE_CASES[case][2]
        assert bool(p[f"{prefix}/seq_on_data"]) == (
            b % MESHES[mname][0] != 0), prefix


@pytest.mark.parametrize("mname", SERVE_MESHES)
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_fsdp_serving_ranks_agree_bit_for_bit(worlds, case, mname):
    """The ranks that hold the same rows give the same logits bits."""
    port, _ = worlds
    key = f"serve/{case}/{mname}/logits"
    rows = f"serve/{case}/{mname}/rows"
    for r, p in enumerate(port):
        same = [q for q in port if np.array_equal(q[rows], p[rows])]
        assert all(np.array_equal(q[key], p[key]) for q in same), (
            f"rank {r} {key}")


@pytest.mark.parametrize("mname", list(MESHES))
def test_reduce_scatter_is_all_gathers_partner(worlds, mname):
    port, _ = worlds
    for r, p in enumerate(port):
        assert p[f"reduce_scatter_ok/{mname}"], f"rank {r} {mname}"


# ------------------------------------------------ the launcher on 2 ranks

SERVE_ARGV = ["--arch", "gemma-2b", "--smoke", "--shape", "long_500k",
              "--steps", "3", "--device", "cpu"]


def _launch_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=2)
    try:
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.launch import serve

        # the launcher's world mesh as (2, 1): B = 1 does not split over
        # the two data ranks, so the cache's sequence lies on "data"
        mesh_mod.WORLD_MODEL_AXIS = 1
        res = serve.main(SERVE_ARGV)
        np.savez(os.path.join(out_dir, f"serve_rank{rank}.npz"),
                 tokens=res["tokens"].numpy(),
                 ms=np.asarray(res["ms_per_token"]))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def serve_world():
    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory() as out_dir:
        tpt._run_world(_launch_worker, 2, (os.path.join(out_dir, "store"),
                                           out_dir))
        ranks = [dict(np.load(os.path.join(out_dir, f"serve_rank{r}.npz")))
                 for r in range(2)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        host = serve.main(SERVE_ARGV + ["--host-mesh"])
    finally:
        torch.set_num_threads(n)
    return ranks, host


def test_long_500k_launcher_on_a_data_axis_emits_the_host_tokens(
        serve_world):
    ranks, host = serve_world
    assert host["tokens"].shape == (1, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], host["tokens"].numpy())
        assert np.isfinite(r["ms"]) and r["ms"] > 0


# ------------------------------------------------------- in this process


def test_parallel_round_with_params_on_data_names_item_13d():
    """The reference ties FSDP to the sequential round: a parallel round
    given specs that put params on "data" refuses, naming item 13d."""
    from repro_torch.core import fl as tfl
    from repro_torch.launch.mesh import ClientMesh
    from repro_torch.models import sharding, transformer

    g = object()
    mesh = ClientMesh(group=g, rank=0, size=4, device=torch.device("cpu"),
                      model=2, data_group=g, model_group=g)
    cfg = port_cfg("gemma-2b")
    specs = sharding.param_pspecs(
        transformer.init_params(None, cfg, device="meta"), mesh, fsdp=True)
    fc = tfl.FLConfig(num_clients=2, clients_per_round=2, local_steps=1,
                      engine="flat_sharded")
    with pytest.raises(NotImplementedError, match="'data'.*item 13d"):
        tfl.make_round_fn(lambda p, b: 0.0, fc, mesh=mesh,
                          param_specs=specs)
