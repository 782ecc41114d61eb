"""The training recompute, the op trace and the dry run of the port
(`models/recompute.py`, `launch/optrace.py`, `launch/dryrun.py`).

(a) `recompute.recompute` gives gradients bitwise equal to plain
    autograd through the same function, under `torch.func.grad` and
    `vmap(grad)`, on a plain function and on a flash-attention LM whose
    groups run under it (the flash Function's plain path on the CPU):
    the backward's rerun reads the flash output back from the tape, so
    the flash forward runs once a layer.
(b) On the meta device the traced peak of a train step grows by one
    residual stream a group added (2 -> 4 and 4 -> 8 groups), and with
    `loss_chunk` by no chunk's logits when the chunks double; neither
    holds with the recompute taken out (checked in the same tests). The
    peak is the same with the cyclic collector off: no reference cycle
    holds a tensor.
(c) `attention._scale` is bit for bit the f32 tensor it replaced, at
    every head dim of the registry.
(d) `optrace` counts hand-checked mm / bmm / addmm / baddbmm /
    convolution programs exactly, their bytes and their allocations.
(e) The train step's traced flops at gemma-2b-smoke equal the JAX
    package's `hlo_scoped.analyze` on the compiled host-mesh step, once
    the one difference of the two programs is counted: XLA drops from
    each group's recompute its last projection (the FFN's `w_down`),
    whose output the backward never reads; the eager recompute runs it.
(f) One full-size `dryrun.run_one("gemma-2b", "train_4k")` writes the
    reference's record keys, and its argument bytes equal the sum of the
    JAX package's `NamedSharding.shard_shape` over the same arguments
    (less the reference's 8-byte PRNG key and 4-byte round, which the
    port holds on the host).
"""
import gc
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.launch import hlo_scoped
from repro.launch import steps as jsteps
from repro_torch.configs import registry
from repro_torch.configs import shapes
from repro_torch.core import treemath
from repro_torch.kernels import flash_attn
from repro_torch.launch import dryrun, optrace, steps
from repro_torch.launch.mesh import AbstractMesh as TorchMesh
from repro_torch.models import attention, recompute, transformer
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


def _no_recompute(fn, *args):
    return tuple(fn(*args))


def _tiny(layers=2, **kw):
    base = dict(name="tiny", arch_type="dense", num_layers=layers,
                d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                vocab_size=64, dtype="float32")
    return ModelConfig(**{**base, **kw})


# ------------------------------------------------------ (a) the gradients


def _f(x, w, b, labels):
    h = torch.tanh(x @ w + b)
    h = torch.nn.functional.gelu(h @ w.T)
    return (h * 0.5 + x, torch.sum(h[..., 0] * labels.to(h.dtype)))


def test_recompute_grads_bitwise_on_a_plain_function():
    """Two calls in a row, each with its own weights (as each group has
    its own params), `w` used twice within a call, integer labels."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 8), np.float32))
    ws = [torch.from_numpy(rng.standard_normal((8, 8), np.float32))
          for _ in range(2)]
    bs = [torch.from_numpy(rng.standard_normal((8,), np.float32))
          for _ in range(2)]
    labels = torch.from_numpy(rng.integers(0, 3, (3, 5)).astype(np.int32))

    def loss(ws, bs, x, labels, use):
        run = recompute.recompute if use else _no_recompute
        y, s = run(_f, x, ws[0], bs[0], labels)
        y, s2 = run(_f, y, ws[1], bs[1], labels)
        return torch.sum(y * y) + s + s2

    out = {}
    for use in (True, False):
        g = torch.func.grad(loss, argnums=(0, 1, 2))(ws, bs, x[0],
                                                     labels[0], use)
        gv = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                             in_dims=(None, None, 0, 0, None))(
            ws, bs, x, labels, use)
        out[use] = treemath.tree_leaves((g, gv))
    assert len(out[True]) == 10
    for a, e in zip(out[True], out[False]):
        assert torch.equal(a, e)


def test_recompute_grads_bitwise_through_the_flash_function(monkeypatch):
    cfg = _tiny(attention_impl="flash")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 2, 64)).astype(np.int32))
    calls = []
    forward = flash_attn._forward

    def counted(*a):
        calls.append(1)
        return forward(*a)

    monkeypatch.setattr(flash_attn, "_forward", counted)

    def grads():
        one = torch.func.grad(lambda p: transformer.loss_fn(
            p, cfg, {"tokens": toks[0]}))(params)
        n_one = len(calls)
        many = torch.func.vmap(torch.func.grad(
            lambda p, t: transformer.loss_fn(p, cfg, {"tokens": t})),
            in_dims=(None, 0))(params, toks)
        return one, many, n_one, len(calls) - n_one

    got = grads()
    calls.clear()
    monkeypatch.setattr(recompute, "recompute", _no_recompute)
    want = grads()
    for a, e in zip(treemath.tree_leaves(got[:2]),
                    treemath.tree_leaves(want[:2])):
        assert torch.equal(a, e)
    # one flash forward a layer with and without the recompute: the
    # backward's rerun of each group reads the first run's output back
    assert got[2:] == want[2:] == (cfg.num_layers, cfg.num_layers)


# --------------------------------------------------------- (b) the peaks


def _train_peak(cfg, t: int) -> int:
    params = transformer.init_params(None, cfg, device=META)
    toks = torch.empty((2, t), dtype=torch.int32, device=META)
    with optrace.OpTrace(keep_ops=False) as trace:
        torch.func.vmap(torch.func.grad(
            lambda p, tk: transformer.loss_fn(p, cfg, {"tokens": tk})),
            in_dims=(None, 0))(params, toks[None].expand(2, 2, t))
    return trace.peak


def _param_bytes(cfg) -> int:
    return sum(x.numel() * x.element_size() for x in treemath.tree_leaves(
        transformer.init_params(None, cfg, device=META)))


@pytest.mark.parametrize("use", [True, False], ids=["recompute", "without"])
def test_meta_peak_grows_one_residual_a_group(monkeypatch, use):
    """K = 2 clients, B = 2, T = 256, d = 32: a layer's (B, H, T, T)
    scores are 32x its (B, T, d) residual. Growth past one residual a
    group is allowed only for the params' own bytes (their grads and the
    stacked gradient of the group selects: 4x the added params)."""
    if not use:
        monkeypatch.setattr(recompute, "recompute", _no_recompute)
    k, b, t, d = 2, 2, 256, 32
    residual = k * b * t * d * 4
    for g1, g2 in ((2, 4), (4, 8)):
        lo, hi = _tiny(g1), _tiny(g2)
        growth = _train_peak(hi, t) - _train_peak(lo, t)
        allowed = ((g2 - g1) * residual
                   + 4 * (_param_bytes(hi) - _param_bytes(lo)))
        assert (growth <= allowed) == use, (g1, g2, growth, allowed)


@pytest.mark.parametrize("use", [True, False], ids=["recompute", "without"])
def test_meta_peak_keeps_no_chunk_logits(monkeypatch, use):
    """loss_chunk 16, vocab 8192: doubling T from 64 to 128 adds 4 chunks,
    whose (K, B, 16, V) f32 logits are 4 MiB each; the recompute keeps
    none of them, so the peak grows by less than one."""
    if not use:
        monkeypatch.setattr(recompute, "recompute", _no_recompute)
    cfg = _tiny(1, vocab_size=8192, loss_chunk=16)
    chunk_logits = 2 * 2 * 16 * cfg.vocab_size * 4
    growth = _train_peak(cfg, 128) - _train_peak(cfg, 64)
    assert (growth < chunk_logits) == use, (growth, chunk_logits)


def test_meta_peak_does_not_wait_for_the_cyclic_collector():
    """A train step leaves no reference cycle holding tensors: its traced
    peak is the same with the cyclic collector off, so the dry run's
    prediction (and the card's peak) does not depend on when it runs.
    `treemath.tree_unflatten` was a recursive closure, a cycle that
    held every unflattened tree's leaves until the collector ran."""
    cfg = registry.smoke("gemma-2b")
    mesh = TorchMesh((1, 1), ("data", "model"))
    peaks = []
    for collect in (True, False):
        fn, args, ins, outs, _ = steps.build_train_step(
            cfg, mesh, shapes.InputShape("train_4k", 64, 2, "train"))
        gc.collect()
        if not collect:
            gc.disable()
        try:
            with optrace.OpTrace(keep_ops=False) as trace:
                del ins, outs
                fn(*args)
            peaks.append(trace.peak)
        finally:
            gc.enable()
    assert peaks[0] == peaks[1]


# --------------------------------------------------------- (c) the scale


def test_scale_is_the_old_f32_value_bit_for_bit():
    dims = {cfg.hd for cfg in registry.ARCHS.values()}
    dims |= {registry.smoke(name).hd for name in registry.ARCHS}
    assert len(dims) >= 4
    for hd in sorted(dims):
        old = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
        new = torch.tensor(attention._scale(hd), dtype=torch.float32)
        assert torch.equal(old.view(torch.int32), new.view(torch.int32)), hd
        assert float(np.float32(attention._scale(hd))) == attention._scale(hd)


# --------------------------------------------------------- (d) the trace


def test_optrace_counts_hand_checked_programs():
    a, b = torch.empty(3, 4, device=META), torch.empty(4, 5, device=META)
    x, y = torch.empty(2, 3, 4, device=META), torch.empty(2, 4, 6, device=META)
    bias = torch.empty(3, 5, device=META)
    sig = torch.empty(2, 8, 10, device=META)
    w1 = torch.empty(8, 2, 3, device=META)  # groups = 4
    img = torch.empty(1, 3, 9, 9, device=META)
    w2 = torch.empty(6, 3, 3, 3, device=META)
    with optrace.OpTrace() as trace:
        c = a @ b  # mm: 2*3*4*5
        torch.bmm(x, y)  # bmm: 2*2*3*4*6
        torch.addmm(bias, a, b)  # 2*3*4*5
        torch.baddbmm(torch.empty(2, 3, 6, device=META), x, y)  # 2*2*3*4*6
        torch.nn.functional.conv1d(sig, w1, groups=4)  # 2*(2*8*8)*(2*3)
        torch.nn.functional.conv2d(img, w2)  # 2*(1*6*7*7)*(3*3*3)
        c.view(15)
        c.add_(1.0)
    want = [120, 288, 120, 288, 1536, 15876]
    assert [op.flops for op in trace.ops if op.flops] == want
    assert trace.flops == sum(want)
    by_name = {op.name: op for op in trace.ops}
    assert by_name["aten.view.default"].bytes == 0  # a view moves nothing
    assert by_name["aten.view.default"].alloc_bytes == 0
    assert by_name["aten.add_.Tensor"].bytes == 2 * 60
    assert by_name["aten.add_.Tensor"].alloc_bytes == 0  # in place
    assert by_name["aten.mm.default"].bytes == 4 * (12 + 20 + 15)
    assert by_name["aten.mm.default"].alloc_bytes == 60
    hist = optrace.op_histogram(trace, ("mm", "bmm"))
    assert hist == {"aten.mm.default": 1, "aten.bmm.default": 1}
    out = optrace.analyze(trace)
    assert out["unknown_trip_loops"] == 0
    assert out["collectives"] == {"total": 0, "count": 0}


def test_optrace_peak_follows_storages_not_tensors():
    with optrace.OpTrace() as trace:
        a = torch.empty(1000, device=META)
        views = [a.view(10, 100), a[:500], a.view(100, 10).T]
        del a
        assert trace.live == 4000  # the views keep one storage alive
        b = torch.empty(2000, device=META)
        assert trace.peak == 12000
        del views, b
    assert trace.live == 0


def test_optrace_convolution_backward():
    x = torch.empty(2, 4, 16, device=META, requires_grad=True)
    w = torch.empty(4, 1, 3, device=META, requires_grad=True)
    with optrace.OpTrace() as trace:
        torch.nn.functional.conv1d(x, w, groups=4).sum().backward()
    fwd = 2 * (2 * 4 * 14) * (1 * 3)
    assert trace.flops == 3 * fwd  # forward, then input and weight grads


# ---------------------------------------------- (e) flops against the JAX


def test_train_step_flops_equal_jax_hlo_scoped():
    name, t, b = "gemma-2b-smoke", 64, 2
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jfn, jargs, jin, jout, _ = jsteps.build_train_step(
        jregistry.get(name), jmesh, jshapes.InputShape("t", t, b, "train"))
    with jax.set_mesh(jmesh):
        text = jax.jit(jfn, in_shardings=jin,
                       out_shardings=jout).lower(*jargs).compile().as_text()
    want = hlo_scoped.analyze(text)["flops"]

    cfg = registry.get(name)
    fn, args, _, _, meta = steps.build_train_step(
        cfg, TorchMesh((1, 1), ("data", "model")),
        shapes.InputShape("t", t, b, "train"))
    with optrace.OpTrace() as trace:
        fn(*args)
    # each group's recompute runs its w_down product, which XLA's
    # dead-code elimination drops (the backward never reads its output)
    tokens = meta["K"] * meta["B"] * t
    w_down = cfg.num_pattern_groups * 2 * tokens * cfg.d_ff * cfg.d_model
    got = trace.flops - w_down
    assert abs(got - want) <= 0.05 * want, (trace.flops, w_down, want)
    assert got == want


# -------------------------------------------------- (f) a full dry run


def test_full_size_dryrun_gemma_train_4k():
    rec = dryrun.run_one("gemma-2b", "train_4k", verbose=False)
    for key in ("arch", "shape", "tag", "mesh", "devices", "meta", "build_s",
                "memory", "flops", "bytes_accessed", "collectives", "scoped",
                "global", "fits", "partition"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert rec["mesh"] == "32x8" and rec["devices"] == 256
    assert rec["partition"] == "ideal" and rec["collectives"] == {}
    assert rec["flops"] == rec["global"]["flops"] / 256
    assert rec["meta"]["K"] == 32 and rec["meta"]["B"] == 8

    jmesh = AbstractMesh((32, 8), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    _, jargs, jin, _, _ = jsteps.build_train_step(
        jregistry.get("gemma-2b"), jmesh, jshapes.SHAPES["train_4k"])
    leaves = jax.tree.leaves(jargs)
    specs = jax.tree.leaves(jin, is_leaf=lambda x: isinstance(x,
                                                              NamedSharding))
    host = (jargs[0].rng, jargs[0].round)  # the port's are host values
    want = sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
               for a, s in zip(leaves, specs)
               if not any(a is h for h in host))
    assert rec["memory"]["argument_bytes"] == want
