"""Tensor-parallel serving (`launch.steps.build_prefill_step` /
`build_decode_step` on a mesh with a model axis) on gloo worlds of CPU
ranks, against the JAX package's unsharded prefill and decode.

One gloo world of 8 CPU ranks (`torch.multiprocessing` spawn, `file://`
store) builds a (2, 4), a (4, 2) and a (1, 8) ("data", "model") mesh;
one JAX subprocess writes its init of every config first, then its
unsharded `forward(mode="prefill")` on the global batch (B = 4, T = 64,
a cache of T + 4) and 3 `decode_step`s on seeded tokens. Each rank
starts from the JAX init, cut to its blocks, and runs the steps' fns on
its data index's rows and its cache blocks. Held at 1e-5: the
last-position logits, the gathered prefill cache, each decode step's
logits and the gathered cache after them, for the smoke configs of
gemma-2b (G = 1: local q heads, gathered KV), granite-20b (G = 1),
minitron-4b (G = 2, flash), starcoder2-15b (G = 2) and starcoder2-15b
with a sliding window of 24 (the prefill rolls the ring, the decode
wraps it), deepseek-v2-lite-16b (MLA + MoE: E = 4 expert-parallel on
M = 2 and 4, the last-dim split on M = 8, whose blocks do not hold whole
MLA heads) and its `q_lora_rank=32` variant. Also held: the ranks of a
data index bit for bit, the gathered caches on every rank bit for bit;
each cache and param leaf of its `shard_shape`; `shard_params` of the
gathered cache gives the blocks back bit for bit; the MoE routing of
every call equal on every rank; the logits gathered only at the position
read (no "tp" all_gather of (B, T, V)).

The serving launcher (`python -m repro_torch.launch.serve --smoke
--shape decode_32k --batch 2 --seq 64 --steps 3`) on a gloo world of 2
ranks emits the host-mesh launcher's tokens. In this process: the block
init is bit for bit the whole init cut to blocks, and serving refuses
the families item 13d leaves out (with FSDP, with B = 1 on two data
ranks, and at the model's decode). Torch runs one intra-op thread a
rank.
"""
import hashlib
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
MESHES = tpt.MESHES
TOL = 1e-5
T, B, STEPS = 64, 4, 3
S = T + STEPS + 1  # the cache's positions
# case -> (registry config, its changes, the port's attention_impl)
CASES = {
    "gemma-2b": ("gemma-2b", {}, "xla"),
    "granite-20b": ("granite-20b", {}, "xla"),
    "minitron-4b": ("minitron-4b", {}, "flash"),
    "starcoder2-15b": ("starcoder2-15b", {}, "xla"),
    "starcoder2-15b-swa": ("starcoder2-15b", {"sliding_window": 24}, "xla"),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}, "xla"),
    "deepseek-v2-lite-16b-q": ("deepseek-v2-lite-16b",
                               {"mla": {"q_lora_rank": 32}}, "xla"),
}
SERVE_CASES = [(c, m) for c in CASES for m in MESHES]


def case_seed(case):
    return 7 + list(CASES).index(case)


def prompt(case):
    rng = np.random.default_rng(case_seed(case))
    return rng.integers(0, 512, (B, T)).astype(np.int32)


def decode_tokens(case):
    rng = np.random.default_rng(100 + case_seed(case))
    return rng.integers(0, 512, (STEPS, B, 1)).astype(np.int32)


# ------------------------------------------------------------ the JAX side


def _jax_cfg(case):
    import dataclasses

    from repro.configs import registry as jregistry

    name, changes, _ = CASES[case]
    cfg = jregistry.smoke(name)
    for field, value in changes.items():  # a dict replaces sub-fields
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, field), **value)
        cfg = dataclasses.replace(cfg, **{field: value})
    return cfg


def jax_main(out_dir):
    """The JAX init of every case first, then its unsharded prefill and
    decode steps."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtr

    inits = {case: jax.tree.map(np.asarray, jtr.init_params(
        jax.random.key(case_seed(case)), _jax_cfg(case))) for case in CASES}
    tpt._save(os.path.join(out_dir, "params.npz"), {
        k: v for case, tree in inits.items()
        for k, v in tpt._flat_paths(case, tree).items()})
    res = {}
    for case in CASES:
        cfg = _jax_cfg(case)
        params = jax.tree.map(jnp.asarray, inits[case])
        logits, _, cache = jax.jit(lambda p, t: jtr.forward(
            p, cfg, {"tokens": t}, mode="prefill", max_len=S))(
            params, jnp.asarray(prompt(case)))
        res[f"{case}/prefill/logits"] = np.asarray(logits[:, -1:])
        res.update(tpt._flat_paths(f"{case}/prefill/cache",
                                   jax.tree.map(np.asarray, cache)))
        step = jax.jit(lambda p, tok, c, pos: jtr.decode_step(
            p, cfg, tok, c, pos))
        for i, tok in enumerate(decode_tokens(case)):
            logits, cache = step(params, jnp.asarray(tok), cache,
                                 jnp.int32(T + i))
            res[f"{case}/decode{i}/logits"] = np.asarray(logits)
        res.update(tpt._flat_paths(f"{case}/decode/cache",
                                   jax.tree.map(np.asarray, cache)))
    tpt._save(os.path.join(out_dir, "jax.npz"), res)


# ----------------------------------------------------------- the port side


def port_cfg(case):
    from repro_torch.configs import registry
    from repro_torch.models.config import with_changes

    name, changes, impl = CASES[case]
    return with_changes(registry.smoke(name),
                        dict(changes, attention_impl=impl))


def _routing_digest(log) -> str:
    h = hashlib.sha256()
    for call in log:
        for key in sorted(call):
            h.update(call[key].contiguous().view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()


def _shapes_ok(blocks, whole_shapes, specs, mesh) -> bool:
    from repro_torch.core import treemath
    from repro_torch.models.sharding import NamedSpec

    return all(
        tuple(x.shape) == NamedSpec(mesh, s).shard_shape(tuple(w.shape))
        for x, w, s in zip(treemath.tree_leaves(blocks),
                           treemath.tree_leaves(whole_shapes),
                           treemath.tree_leaves_like(whole_shapes, specs)))


def _port_serve(case, mname, mesh, params_np):
    """Prefill and 3 decode steps through the step builders' fns on this
    rank's blocks and rows."""
    from repro_torch import convert
    from repro_torch.configs import shapes
    from repro_torch.core import treemath
    from repro_torch.launch import steps
    from repro_torch.models import moe, sharding, transformer

    cfg = port_cfg(case)
    whole = convert.lm_params_from_numpy(params_np, cfg, device="cpu")
    meta_params = transformer.init_params(None, cfg, device="meta")
    specs = sharding.param_pspecs(meta_params, mesh)
    params = sharding.shard_params(whole, mesh, specs)
    del whole
    prefill, pargs, _, _, _ = steps.build_prefill_step(
        cfg, mesh, shapes.InputShape("prefill", S, B, "prefill"))
    decode, dargs, _, _, _ = steps.build_decode_step(
        cfg, mesh, shapes.InputShape("decode", S, B, "decode"))
    cspecs = sharding.cache_pspecs(dargs[2], mesh)
    rows = B // mesh.client_size
    r0 = mesh.client_index * rows
    prefix = f"{case}/{mname}"
    res = {f"{prefix}/rows": np.asarray([r0, rows])}
    with torch.no_grad(), moe.record_routing() as routing, \
            mesh.recording() as log:
        logits, cache = prefill(params, {"tokens": torch.from_numpy(
            prompt(case)[r0:r0 + rows])})
        res[f"{prefix}/prefill/logits"] = logits.numpy()
        res[f"{prefix}/prefill/cache_shapes_ok"] = np.asarray(
            _shapes_ok(cache, dargs[2], cspecs, mesh))
        # a copy: where nothing is cut the gathered leaf is the cache,
        # which the decode writes into
        whole_cache = treemath.tree_map(
            torch.clone, sharding.gather_params(cache, mesh, cspecs))
        res.update(tpt._flat_paths(f"{prefix}/prefill/cache", whole_cache))
        # shard_params is gather_params's inverse on the cache, bit for bit
        res[f"{prefix}/cache_roundtrip_ok"] = np.asarray(all(
            torch.equal(a, b) for a, b in zip(
                treemath.tree_leaves(sharding.shard_params(
                    whole_cache, mesh, cspecs)),
                treemath.tree_leaves(cache))))
        for i, tok in enumerate(decode_tokens(case)):
            logits, cache = decode(params, torch.from_numpy(
                tok[r0:r0 + rows]), cache, T + i)
            res[f"{prefix}/decode{i}/logits"] = logits.numpy()
    res[f"{prefix}/decode/cache_shapes_ok"] = np.asarray(
        _shapes_ok(cache, dargs[2], cspecs, mesh))
    res.update(tpt._flat_paths(f"{prefix}/decode/cache",
                               sharding.gather_params(cache, mesh, cspecs)))
    res[f"{prefix}/param_shapes_ok"] = np.asarray(
        _shapes_ok(params, meta_params, specs, mesh))
    res[f"{prefix}/routing"] = np.asarray(_routing_digest(routing))
    res[f"{prefix}/routing_calls"] = np.asarray(len(routing))
    # the largest "tp" all_gather: at most the rows' logits of one position
    res[f"{prefix}/largest_tp_gather"] = np.asarray(max(
        [c.nbytes for c in log if c.op == "all_gather" and c.scope == "tp"],
        default=0))
    res[f"{prefix}/tp_collectives"] = np.asarray(
        sum(c.scope == "tp" for c in log))
    return res


def _port_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_client_mesh

        meshes = {name: make_client_mesh(device="cpu", model=shape[1])
                  for name, shape in MESHES.items()}
        inits = tpt._load_when_written(os.path.join(out_dir, "params.npz"))
        res = {}
        for case, mname in SERVE_CASES:
            res.update(_port_serve(case, mname, meshes[mname],
                                   tpt._nested(inits, case)))
        np.savez(os.path.join(out_dir, f"port_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _start_jax(out_dir):
    prog = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "import test_torch_tp_serve as t; "
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


@pytest.mark.parametrize("case,mname", SERVE_CASES)
def test_tp_prefill_and_decode_match_the_jax_model(worlds, case, mname):
    port, jx = worlds
    for r, p in enumerate(port):
        r0, rows = p[f"{case}/{mname}/rows"]
        for step in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
            _close(p[f"{case}/{mname}/{step}/logits"],
                   jx[f"{case}/{step}/logits"][r0:r0 + rows],
                   f"rank {r} {case} {mname} {step} logits")
    p = port[0]
    for stage in ("prefill", "decode"):
        keys = [k for k in jx if k.startswith(f"{case}/{stage}/cache/")]
        assert keys
        for key in keys:
            _close(p[f"{case}/{mname}/{key[len(case) + 1:]}"], jx[key],
                   f"{case} {mname} {key}")


@pytest.mark.parametrize("case,mname", SERVE_CASES)
def test_ranks_agree_bit_for_bit(worlds, case, mname):
    """The ranks of a data index give the same logits bits; every rank
    gathers the same caches and routes alike."""
    port, _ = worlds
    m = MESHES[mname][1]
    prefix = f"{case}/{mname}/"
    for r in range(1, WORLD):
        first = port[r - r % m]  # model index 0 of rank r's data index
        for key, v in port[r].items():
            if not key.startswith(prefix):
                continue
            own_rows = "/logits" in key or key.endswith("/rows")
            other = first if own_rows else port[0]
            assert np.array_equal(v, other[key]), f"rank {r} {key}"


@pytest.mark.parametrize("case,mname", SERVE_CASES)
def test_serving_state_stays_in_blocks(worlds, case, mname):
    """Each cache and param leaf of its shard shape; the collectives under
    "tp"; no "tp" all_gather larger than a position's logits of every
    data index's rows (the MoE's row gather is (B, d) at T = 1)."""
    port, _ = worlds
    cfg = port_cfg(case)
    limit = B * max(T * cfg.d_model, cfg.vocab_size) * 4
    for r, p in enumerate(port):
        prefix = f"{case}/{mname}"
        for key in ("prefill/cache_shapes_ok", "decode/cache_shapes_ok",
                    "param_shapes_ok", "cache_roundtrip_ok"):
            assert p[f"{prefix}/{key}"], f"rank {r} {prefix} {key}"
        assert p[f"{prefix}/tp_collectives"] > 0
        assert p[f"{prefix}/largest_tp_gather"] < limit, (
            r, p[f"{prefix}/largest_tp_gather"])


@pytest.mark.parametrize("case,mname", [
    (c, m) for c, m in SERVE_CASES if c.startswith("deepseek")])
def test_moe_routing_is_equal_on_every_rank(worlds, case, mname):
    """Every MoE call routes the same assignments, slots, keep flags and
    gates on every rank (every data index's rows, gathered)."""
    port, _ = worlds
    cfg = port_cfg(case)
    key = f"{case}/{mname}/routing"
    assert int(port[0][f"{key}_calls"]) == cfg.num_layers * (1 + STEPS)
    assert len({str(p[key]) for p in port}) == 1


# ------------------------------------------------ the launcher on 2 ranks

SERVE_ARGV = ["--arch", "gemma-2b", "--smoke", "--shape", "decode_32k",
              "--batch", "2", "--seq", "64", "--steps", "3", "--device",
              "cpu"]


def _launch_worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=2)
    try:
        from repro_torch.launch import serve

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


def test_serve_launcher_off_the_host_mesh_emits_the_host_tokens(
        serve_world, capsys):
    ranks, host = serve_world
    assert host["tokens"].shape == (2, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], host["tokens"].numpy())
        assert np.isfinite(r["ms"]) and r["ms"] > 0


# ------------------------------------------------------- in this process


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_block_init_is_the_whole_init_cut(arch, mname):
    """`init_params(..., mesh=, specs=)` on every rank of a mesh is bit
    for bit `shard_params(init_params(...))`, and `shard_params` cuts
    the blocks `fl_shard_map.local_blocks` cuts."""
    from repro_torch.configs import registry
    from repro_torch.core import fl_shard_map as tsm
    from repro_torch.core import treemath
    from repro_torch.launch.mesh import ClientMesh
    from repro_torch.models import sharding, transformer

    cfg = registry.smoke(arch)
    data, model = MESHES[mname]
    g = object()
    whole = transformer.init_params(torch.Generator().manual_seed(3), cfg)
    for rank in range(data * model):
        mesh = ClientMesh(group=g, rank=rank, size=data * model,
                          device=torch.device("cpu"), model=model,
                          data_group=g if data > 1 else None,
                          model_group=g)
        specs = sharding.param_pspecs(whole, mesh)
        want = sharding.shard_params(whole, mesh, specs)
        got = transformer.init_params(torch.Generator().manual_seed(3), cfg,
                                      mesh=mesh, specs=specs)
        cut = tsm.local_blocks(
            mesh, treemath.tree_map(lambda x: x[None], whole), specs)
        assert treemath.tree_paths(got) == treemath.tree_paths(want)
        for a, b, c in zip(treemath.tree_leaves(got),
                           treemath.tree_leaves(want),
                           treemath.tree_leaves(cut)):
            assert a.dtype == b.dtype and torch.equal(a, b)
            assert torch.equal(b, c[0])


def _fake_mesh(data=2, model=2):
    from repro_torch.launch.mesh import ClientMesh

    g = object()
    return ClientMesh(group=g, rank=0, size=data * model,
                      device=torch.device("cpu"), model=model,
                      data_group=g if data > 1 else None, model_group=g)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_fsdp_serving_names_item_13d(kind):
    """FSDP serving runs for the decoder-only families
    (`tests/test_torch_fsdp.py`); jamba-1.5-large-398b, the registry's
    other model above the FSDP threshold, refuses it: its Mamba blocks
    have no tensor-parallel form."""
    from repro_torch.configs import registry, shapes
    from repro_torch.launch import steps

    build = {"prefill": steps.build_prefill_step,
             "decode": steps.build_decode_step}[kind]
    with pytest.raises(NotImplementedError, match="jamba.*item 13d"):
        build(registry.smoke("jamba-1.5-large-398b"), _fake_mesh(),
              shapes.InputShape(kind, S, B, kind), fsdp=True)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_batch_that_does_not_split_over_data_names_item_13d(kind):
    """B = 1 on two data ranks (long_500k's case) puts the cache's
    sequence on "data" for the attention families
    (`tests/test_torch_fsdp.py`); RWKV-6, whose state has no sequence,
    still refuses: its blocks have no tensor-parallel form."""
    from repro_torch.configs import registry, shapes
    from repro_torch.launch import steps

    build = {"prefill": steps.build_prefill_step,
             "decode": steps.build_decode_step}[kind]
    with pytest.raises(NotImplementedError, match="rwkv.*item 13d"):
        build(registry.smoke("rwkv6-3b"), _fake_mesh(),
              shapes.InputShape(kind, S, 1, kind))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b",
                                  "whisper-small", "qwen2-vl-2b"])
def test_the_families_left_out_name_item_13d(arch):
    """Serving (both step builders, and the model's decode) and
    training refuse the families item 13d leaves out."""
    from repro_torch.configs import registry, shapes
    from repro_torch.launch import steps
    from repro_torch.models import tp, transformer

    cfg = registry.smoke(arch)
    mesh = _fake_mesh()
    for build, kind in ((steps.build_prefill_step, "prefill"),
                        (steps.build_decode_step, "decode"),
                        (steps.build_train_step, "train")):
        with pytest.raises(NotImplementedError, match="item 13d"):
            build(cfg, mesh, shapes.InputShape(kind, S, B, kind))
    params = transformer.init_params(None, cfg, device="meta")
    cache = transformer.init_cache(cfg, B, S, device="meta")
    tok = torch.zeros((B, 1), dtype=torch.int32, device="meta")
    with tp.scope(mesh), pytest.raises(NotImplementedError,
                                       match="tensor-parallel.*item 13d"):
        transformer.decode_step(params, cfg, tok, cache, 0)
