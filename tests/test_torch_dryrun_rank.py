"""The dry run's per-rank record (`launch/dryrun.py::rank_record` on
`launch.mesh.make_trace_mesh`) against a real rank and against the JAX
package's per-device program.

Seven steps at the smoke configs on a (2, 4) ("data", "model") mesh:
gemma-2b's parallel train step (flat_sharded, tensor-parallel over
"model"), deepseek-v2-lite-16b's sequential train step (FSDP over
"data", MLA + MoE, stale angles, T = 40 so that the MoE's gathered rows
(80) and capacity (56) are dims no other product has), gemma-2b's
`fsdp=True` prefill (B = 4, rows over "data") and its `fsdp=True`
decode at B = 1 (the cache's sequence on "data"),
jamba-1.5-large-398b's parallel train step (Mamba + attention + MoE
tensor-parallel, the selective scan one op a pass), whisper-small's
parallel train step (the encoder stack and the cross-attention on the
rank's heads) and qwen2-vl-2b's prefill (the vision prefix and M-RoPE
on the rank's heads, its (3, B, T) positions cut on their B dim).

(a) One gloo world of 8 CPU ranks (`torch.multiprocessing` spawn,
    `file://` store) runs the four steps for real under
    `optrace.OpTrace` and `mesh.recording()`. Ranks 0 and 7 then build
    the same steps on a trace mesh of their shape and rank and call
    `dryrun.rank_record`: the collective list is the real rank's op for
    op (op, axes, shape, bytes, scope), the flops are equal, and so are
    the argument and output bytes (the parallel round's rank is handed
    the whole batch: its own rows are counted, and the whole batch in
    `held_argument_bytes`).
(b) A JAX subprocess with 8 host devices builds the reference's steps on
    a (2, 4) mesh of Auto axes. The record's argument and output bytes
    equal the sums of the JAX `NamedSharding.shard_shape` bytes (less
    the reference's rng key and round, which the port holds on the
    host), and its flops equal `hlo_scoped.analyze` of the compiled
    per-device HLO once each difference of the two programs is counted
    (`_counted`), with at most 5% left uncounted. The two collective
    histograms are printed side by side, not held equal: XLA's
    partitioner picks its own collectives.
(c) Whisper (whisper-smoke), which kept the ideal partition until its
    encoder and cross-attention ran tensor-parallel, takes the rank
    partition, with its "tp" collectives, as the recurrent rwkv6-smoke
    does.
(d) A trace-mesh collective on a CPU tensor raises.
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
WORLD = 8
MESH = (2, 4)
RANKS = (0, 7)  # the first rank and the last, on the other data index
JOIN_TIMEOUT = 300  # seconds for the gloo world and the JAX subprocess
UNCOUNTED = 0.05
# case -> (arch, step kind, T or S, global B, builder keywords)
CASES = {
    "tp_train": ("gemma-2b", "train", 64, 4, {}),
    "fsdp_train": ("deepseek-v2-lite-16b", "train", 40, 32,
                   {"fl_mode": "sequential", "stale": True}),
    "fsdp_prefill": ("gemma-2b", "prefill", 64, 4, {"fsdp": True}),
    "seq_decode": ("gemma-2b", "decode", 130, 1, {"fsdp": True}),
    "jamba_tp_train": ("jamba-1.5-large-398b", "train", 64, 4, {}),
    "whisper_tp_train": ("whisper-small", "train", 64, 4, {}),
    "qwen_prefill": ("qwen2-vl-2b", "prefill", 64, 4, {}),
}
DECODE_POS = 5


def _builder(steps, kind):
    return {"train": steps.build_train_step,
            "prefill": steps.build_prefill_step,
            "decode": steps.build_decode_step}[kind]


def _build(case, mesh):
    """The port's step of `case` on `mesh`: (cfg, fn, args, in_specs,
    out_specs, meta)."""
    from repro_torch.configs import registry, shapes
    from repro_torch.launch import steps

    arch, kind, t, b, kw = CASES[case]
    cfg = registry.get(arch + "-smoke")
    built = _builder(steps, kind)(cfg, mesh,
                                  shapes.InputShape(case, t, b, kind), **kw)
    return (cfg,) + tuple(built)


def _batch(args_batch, cfg, rng) -> dict:
    """Seeded numpy-drawn tensors of a step's batch shapes: token ids in
    the vocab, M-RoPE positions in the sequence, the stub embeddings
    normal."""
    out = {}
    for key, x in args_batch.items():
        shape = tuple(x.shape)
        if key == "tokens":
            v = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        elif key == "positions":
            v = rng.integers(0, shape[-1], shape).astype(np.int32)
        else:
            v = rng.standard_normal(shape).astype(np.float32)
        out[key] = torch.from_numpy(v)
    return out


def _whole_batch(case, meta) -> bool:
    return CASES[case][1] == "train" and meta["fl_mode"] == "parallel"


def _log_rows(log) -> list:
    return [[c.op, list(c.axes), list(c.shape), c.nbytes, c.scope]
            for c in log]


# ------------------------------------------------------- (a) the world


def _real_rank(case, mesh) -> dict:
    """`case`'s step run for real on this rank's blocks and rows."""
    from repro_torch.core import fl as tfl
    from repro_torch.launch import optrace, steps
    from repro_torch.models import sharding, transformer

    cfg, fn, args, ins, outs, meta = _build(case, mesh)
    kind = CASES[case][1]
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1 + sorted(CASES).index(case))
    if kind == "train":
        fc = tfl.FLConfig(**meta["flcfg"])
        specs = sharding.param_pspecs(
            args[0].params, mesh, fsdp=meta["fl_mode"] == "sequential")
        state = tfl.init_round_state(fc, transformer.init_params(gen, cfg))
        state = state._replace(
            params=sharding.shard_params(state.params, mesh, specs),
            prev_delta=sharding.shard_params(state.prev_delta, mesh, specs))
        whole = _batch(args[1], cfg, rng)
        rows = steps.local_batch(whole, ins[1], mesh)
        k = meta["K"]
        tail = (torch.arange(k, dtype=torch.int32),
                torch.from_numpy((10.0 * (1 + np.arange(k))).astype(
                    np.float32)))
        call = (state, whole if _whole_batch(case, meta) else rows) + tail
        counted = (state, rows) + tail
    else:
        specs = sharding.param_pspecs(args[0], mesh,
                                      fsdp=CASES[case][4].get("fsdp", False))
        params = transformer.init_params(gen, cfg, mesh=mesh, specs=specs)
        if kind == "prefill":
            call = (params, steps.local_batch(_batch(args[1], cfg, rng),
                                              ins[1], mesh))
        else:
            b, s = meta["B"], meta["S"]
            token = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, tuple(args[1].shape)).astype(np.int32))
            call = (params, sharding.block(token, mesh, ins[1].spec),
                    transformer.init_cache(cfg, b, s, device="cpu",
                                           mesh=mesh),
                    torch.tensor(DECODE_POS, dtype=torch.int32))
        counted = call
    held = sum(x.numel() * x.element_size()
               for _, x in steps.spec_leaves(ins, call))
    with optrace.OpTrace(keep_ops=False) as trace, \
            mesh.recording() as log:
        out = fn(*call)
    nbytes = [sum(x.numel() * x.element_size()
                  for _, x in steps.spec_leaves(specs_, tree))
              for specs_, tree in ((ins, counted), (outs, out))]
    return {"log": _log_rows(log), "flops": trace.flops,
            "argument_bytes": nbytes[0], "output_bytes": nbytes[1],
            "held_bytes": held}


def _moe_flops(ops, dims) -> float:
    """The flops of the products with a dim in `dims` (the MoE's
    gathered rows and expert capacity)."""
    return sum(op.flops for op in ops
               if op.flops and any(d in dims for s in op.in_shapes
                                   for d in s))


def _traced_rank(case, rank: int) -> dict:
    """`case`'s record on a trace mesh of the world's shape at `rank`;
    on rank 0 also the products the count of (b) reads."""
    from repro_torch.launch import dryrun, optrace, steps
    from repro_torch.launch.mesh import make_trace_mesh

    mesh = make_trace_mesh(MESH, rank)
    cfg, fn, args, ins, outs, meta = _build(case, mesh)
    with mesh.recording() as log:
        rec = dryrun.rank_record(fn, args, ins, outs, mesh,
                                 whole_batch=_whole_batch(case, meta))
    out = {"log": _log_rows(log), "flops": rec["flops"],
           "argument_bytes": rec["memory"]["argument_bytes"],
           "output_bytes": rec["memory"]["output_bytes"],
           "held_bytes": rec["held_argument_bytes"],
           "collectives": rec["collectives"],
           "meta": {k: meta[k] for k in ("K", "B") if k in meta}}
    if rank == 0:
        blocks = steps.rank_blocks(ins, args, mesh)
        if _whole_batch(case, meta):
            blocks = (blocks[0], args[1]) + tuple(blocks[2:])
        with optrace.OpTrace() as trace:
            fn(*blocks)
        out["mm_flops"] = sum(op.flops for op in trace.ops
                              if op.name == "aten.mm.default")
        if cfg.moe is not None:
            t, b = CASES[case][2], CASES[case][3] // meta["K"]
            out["moe_rows"] = b * t
            out["moe_capacity"] = _capacity(cfg, b * t)
            out["moe_flops"] = _moe_flops(
                trace.ops, {out["moe_rows"], out["moe_capacity"]})
        out["cfg"] = {"groups": cfg.num_pattern_groups, "d": cfg.d_model,
                      "d_ff": cfg.d_ff, "encoder_layers": cfg.encoder_layers,
                      "encoder_len": cfg.encoder_len,
                      "d_ff_expert": cfg.moe.d_ff_expert if cfg.moe else 0,
                      "shared": cfg.moe.num_shared if cfg.moe else 0,
                      "experts": cfg.moe.num_experts if cfg.moe else 0}
    return out


def _capacity(cfg, tokens: int) -> int:
    from repro_torch.models import moe

    return moe._capacity(tokens, cfg.moe)


def _worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_client_mesh

        mesh = make_client_mesh(device="cpu", model=MESH[1])
        real = {case: _real_rank(case, mesh) for case in CASES}
    finally:
        dist.destroy_process_group()
    if rank in RANKS:
        res = {case: {"real": real[case], "trace": _traced_rank(case, rank)}
               for case in CASES}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)


# ------------------------------------------------------ (b) the JAX side


def jax_main(out_dir):
    """The reference's steps on a (2, 4) Auto mesh of 8 host devices:
    shard bytes, per-device flops and collectives, to jax.json."""
    import math

    import jax
    from jax.sharding import AxisType, NamedSharding

    from repro.configs import registry as jr
    from repro.configs import shapes as js
    from repro.launch import hlo, hlo_scoped
    from repro.launch import steps as jst

    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    is_spec = lambda x: isinstance(x, NamedSharding)  # noqa: E731

    def shard_bytes(specs, tree, host):
        leaves = jax.tree.leaves(tree)
        specs = jax.tree.leaves(specs, is_leaf=is_spec)
        assert len(leaves) == len(specs)
        return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
                   for a, s in zip(leaves, specs)
                   if not any(a is h for h in host))

    res = {}
    for case, (arch, kind, t, b, kw) in CASES.items():
        fn, args, ins, outs, _ = _builder(jst, kind)(
            jr.get(arch + "-smoke"), mesh, js.InputShape(case, t, b, kind),
            **kw)
        out_sds = jax.eval_shape(fn, *args)
        host_in = (args[0].rng, args[0].round) if kind == "train" else ()
        host_out = ((out_sds[0].rng, out_sds[0].round) if kind == "train"
                    else ())
        with jax.set_mesh(mesh):
            text = jax.jit(fn, in_shardings=ins, out_shardings=outs).lower(
                *args).compile().as_text()
        res[case] = {"argument_bytes": shard_bytes(ins, args, host_in),
                     "output_bytes": shard_bytes(outs, out_sds, host_out),
                     "flops": hlo_scoped.analyze(text)["flops"],
                     "collectives": hlo.collective_bytes(text)}
    with open(os.path.join(out_dir, "jax.json"), "w") as f:
        json.dump(res, f)


def _start_jax(out_dir):
    prog = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "import test_torch_dryrun_rank as t; "
            f"t.jax_main({out_dir!r})")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def worlds():
    """({rank: {case: {"real", "trace"}}}, {case: the JAX figures})."""
    with tempfile.TemporaryDirectory() as out_dir:
        jax_proc = _start_jax(out_dir)
        try:
            ctx = mp.start_processes(
                _worker, args=(os.path.join(out_dir, "store"), out_dir),
                nprocs=WORLD, join=False, start_method="spawn")
            deadline = time.monotonic() + JOIN_TIMEOUT
            try:
                while not ctx.join(timeout=1.0):
                    if time.monotonic() > deadline:
                        raise AssertionError("the gloo world did not "
                                             f"finish in {JOIN_TIMEOUT} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
            _, err = jax_proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if jax_proc.poll() is None:
                jax_proc.kill()
        assert jax_proc.returncode == 0, err[-3000:]
        ranks = {}
        for r in RANKS:
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks[r] = json.load(f)
        with open(os.path.join(out_dir, "jax.json")) as f:
            jx = json.load(f)
    return ranks, jx


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", list(CASES))
def test_trace_mesh_collectives_are_the_real_ranks(worlds, case, rank):
    got = worlds[0][rank][case]
    real, traced = got["real"], got["trace"]
    assert real["log"], case  # every step runs collectives on (2, 4)
    assert len(traced["log"]) == len(real["log"])
    for i, (t, r) in enumerate(zip(traced["log"], real["log"])):
        assert t == r, (case, rank, i, t, r)
    assert traced["collectives"]["count"] == len(real["log"])


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", list(CASES))
def test_trace_mesh_flops_and_bytes_are_the_real_ranks(worlds, case, rank):
    got = worlds[0][rank][case]
    real, traced = got["real"], got["trace"]
    assert traced["flops"] == real["flops"] > 0
    for key in ("argument_bytes", "output_bytes", "held_bytes"):
        assert traced[key] == real[key], (case, rank, key)


@pytest.mark.parametrize("case", list(CASES))
def test_record_bytes_equal_the_jax_shard_shapes(worlds, case):
    traced, jx = worlds[0][0][case]["trace"], worlds[1][case]
    assert traced["argument_bytes"] == jx["argument_bytes"]
    assert traced["output_bytes"] == jx["output_bytes"]


def _counted(case, traced) -> dict:
    """Each difference of the port's rank program from XLA's per-device
    program, in flops (port minus XLA), by name."""
    cfg, meta = traced["cfg"], traced["meta"]
    data = MESH[0]
    t, b = CASES[case][2], CASES[case][3]
    out = {}
    if case in ("tp_train", "whisper_tp_train"):
        # XLA's dead-code elimination drops each group's recomputed
        # w_down, whose output the backward never reads (as in
        # test_torch_dryrun.py's (e)); the rank's block of it, in the
        # encoder's groups too (over its encoder_len frames)
        rows = (meta["K"] // data) * meta["B"]
        out["recomputed w_down"] = (
            (cfg["groups"] * t + cfg["encoder_layers"] * cfg["encoder_len"])
            * rows * 2 * cfg["d_ff"] * cfg["d"] / MESH[1])
    if case == "fsdp_train":
        # the port routes every data index's rows together and runs the
        # experts (routed and shared) on all of them with the model
        # block whole on every data rank; XLA splits those products'
        # contraction over "data"
        out["MoE over every data index's rows"] = (
            traced["moe_flops"] * (1 - 1 / data))
        # XLA drops each group's recomputed expert w_down (routed:
        # capacity x d_ff_expert x d a local expert; shared: every row),
        # at its own size, 1 / data of the port's
        rows, cap = traced["moe_rows"], traced["moe_capacity"]
        local_experts = cfg["experts"] // MESH[1]
        per_group = 2 * cfg["d"] * (
            cap * cfg["d_ff_expert"] * local_experts
            + rows * cfg["d_ff_expert"] * cfg["shared"] / MESH[1])
        out["recomputed expert w_down"] = (
            meta["K"] * cfg["groups"] * per_group / data)
    if case == "seq_decode":
        # B = 1 does not split over "data": every data rank multiplies
        # the gathered weights whole for the one row, where XLA splits
        # each product's contraction (or its output) over "data"
        out["weights whole on every data rank"] = (
            traced["mm_flops"] * (1 - 1 / data))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_record_flops_equal_the_jax_per_device_hlo(worlds, case):
    traced, jx = worlds[0][0][case]["trace"], worlds[1][case]
    counted = _counted(case, traced)
    rest = traced["flops"] - sum(counted.values()) - jx["flops"]
    msg = (f"{case}: port {traced['flops']:.6g} flops, counted {counted}, "
           f"XLA {jx['flops']:.6g}; uncounted {rest:.6g}; collectives "
           f"port {traced['collectives']} | XLA {jx['collectives']}")
    assert abs(rest) <= UNCOUNTED * jx["flops"], msg
    print(msg)


# ------------------------------------------------- (c) and (d) in process


def test_uncovered_family_keeps_the_ideal_partition():
    """Whisper, the family the dry run traced whole ("ideal") until its
    encoder and cross-attention ran tensor-parallel: its record is rank
    0's program, with its "tp" collectives (the cross cache's KV heads
    on "model")."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_one("whisper-small-smoke", "decode_32k", verbose=False)
    assert rec["partition"] == "rank" and rec["rank"] == 0
    assert rec["collectives"]["by_scope"]["tp"]["count"] > 0
    assert rec["live_bytes"] == (
        rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"]
        + rec["memory"]["temp_bytes"] - rec["memory"]["alias_bytes"])


def test_recurrent_family_takes_the_rank_partition():
    """RWKV-6 is covered: its record is rank 0's program, with its "tp"
    collectives (the WKV state's heads on "model")."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_one("rwkv6-3b-smoke", "decode_32k", verbose=False)
    assert rec["partition"] == "rank"
    assert rec["collectives"]["by_scope"]["tp"]["count"] > 0


@pytest.mark.parametrize("op", ["all_reduce", "all_gather",
                                "reduce_scatter", "broadcast"])
def test_trace_mesh_refuses_a_cpu_tensor(op):
    from repro_torch.launch.mesh import make_trace_mesh

    mesh = make_trace_mesh(MESH, 3)
    call = {"all_reduce": lambda t: mesh.all_reduce(t),
            "all_gather": lambda t: mesh.all_gather(t, dim=1),
            "reduce_scatter": lambda t: mesh.reduce_scatter(t),
            "broadcast": lambda t: mesh.broadcast(t, 0)}[op]
    with mesh.recording() as log:
        out = call(torch.empty(4, 4, device="meta"))
        with pytest.raises(ValueError, match="meta"):
            call(torch.zeros(4, 4))
    assert out.device.type == "meta" and len(log) == 1
