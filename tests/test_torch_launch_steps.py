"""The step builders and the training launcher of the port
(`launch/steps.py`, `launch/train.py`) against the JAX package.

(a) `build_train_step`, `build_prefill_step` and `build_decode_step` on
    the reduced config of every arch: `meta` equals the JAX builder's,
    and the arguments' and outputs' shapes and dtypes equal the JAX
    builder's arguments and `jax.eval_shape` of its step (the port's
    outputs from one run of `fn` on the meta device). The JAX builders
    run on a (1, 1) host mesh with Auto axes: jax 0.9.0's
    `make_host_mesh()` has Explicit axes, on which the reference's
    `with_sharding_constraint` raises. The reference's PRNG key and
    round are device values; the port's are host values, not compared.
(b) The port's train `fn` built on an abstract (4, 1) mesh (K = 4) runs
    on CPU tensors, params carried across from the JAX init, against
    `jax.jit(make_round_fn(loss, FLConfig(**meta["flcfg"]), None,
    pred))` at 1e-5 over 2 rounds: gemma-2b-smoke, and
    deepseek-v2-lite-16b-smoke (MoE) with angle_filter="dense_only".
(c) The launcher on the CPU: 3 rounds, then 2 rounds with a checkpoint
    and `python -m repro_torch.launch.train ... --resume` to 3 with
    `--telemetry`: the resumed `params_sha256` equals the
    uninterrupted one and the stream validates. Without `--host-mesh` and
    without a process group (no torchrun) it raises RuntimeError saying
    so; on a world it runs tensor-parallel (tests/test_torch_tp.py).
    Torch runs on one intra-op thread: several CPU threads sum in an
    order that changes from process to process.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.core import fl as jfl
from repro.core.weighting import AngleState as JAngleState
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import registry, shapes
from repro_torch.core import fl as tfl
from repro_torch.core import treemath
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import AbstractMesh as TorchMesh
from repro_torch.telemetry import schema, sinks

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = sorted(registry.ARCHS)
SMALL = {"train": (8, 2), "prefill": (16, 2), "decode": (32, 2)}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _pairs(jtree, ttree):
    """[(keys, jax leaf, port leaf)] by sorted key path; JAX NamedTuples
    by field name; None and host values on the port's side skipped."""
    out = []

    def walk(j, t, keys):
        if isinstance(t, dict):
            assert set(t) == set(j), keys
            for k in sorted(t):
                walk(j[k], t[k], keys + (k,))
        elif hasattr(t, "_fields"):
            for f in t._fields:
                if hasattr(j, f):
                    walk(getattr(j, f), getattr(t, f), keys + (f,))
        elif isinstance(t, (tuple, list)):
            assert len(t) == len(j), keys
            for i, (a, b) in enumerate(zip(j, t)):
                walk(a, b, keys + (i,))
        elif isinstance(t, torch.Tensor):
            out.append((keys, j, t))

    walk(jtree, ttree, ())
    return out


def _same_shapes(jtree, ttree):
    pairs = _pairs(jtree, ttree)
    assert pairs
    for keys, j, t in pairs:
        assert tuple(j.shape) == tuple(t.shape), keys
        assert jnp.dtype(j.dtype) == jnp.dtype(
            str(t.dtype).replace("torch.", "")), keys


def _build(kind, arch, monkeypatch):
    """The port's and the JAX package's builds of one step; the JAX
    step's output shapes are its builder's own `jax.eval_shape` of it
    (the builder's last call: tracing the step again would double the
    test's time)."""
    cfg, jcfg = registry.smoke(arch), jregistry.smoke(arch)
    t, b = SMALL[kind]
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    shape = shapes.InputShape(name, t, b, kind)
    jshape = jshapes.InputShape(name, t, b, kind)
    builder = {"train": "build_train_step", "prefill": "build_prefill_step",
               "decode": "build_decode_step"}[kind]
    got = getattr(steps, builder)(cfg, TorchMesh((1, 1), ("data", "model")),
                                  shape)
    seen = []
    eval_shape = jax.eval_shape

    def spy(*a, **kw):
        seen.append(eval_shape(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(jax, "eval_shape", spy)
    with jax.set_mesh(_jmesh()):
        want = getattr(jsteps, builder)(jcfg, _jmesh(), jshape)
    monkeypatch.undo()
    return got, want, seen[-1]


# ------------------------------------------------------ (a) the builders


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_builders_match_the_references(arch, kind, monkeypatch):
    (fn, args, in_specs, out_specs, meta), (jfn, jargs, *_, jmeta), jout = \
        _build(kind, arch, monkeypatch)
    assert meta == jmeta
    _same_shapes(jargs, args)
    out = fn(*args)
    _same_shapes(jout, out)
    if kind == "train":
        assert set(out[1]) == set(jout[1])  # the metrics' keys
    # every argument and output tensor has a spec (a spec at a node
    # covers the leaves below it)
    for specs, tree in ((in_specs, args), (out_specs, out)):
        assert len(steps.spec_leaves(specs, tree)) == len(
            [x for x in treemath.tree_leaves(tree)
             if isinstance(x, torch.Tensor)])


def test_build_step_dispatches_by_shape_kind():
    mesh = TorchMesh((32, 8), ("data", "model"))
    for name, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                       ("decode_32k", "decode")):
        *_, meta = steps.build_step("gemma-2b", name, mesh)
        assert ("K" in meta) == (kind == "train")
        assert ("S" in meta) == (kind == "decode")


# -------------------------------------------- (b) the train fn vs the JAX


@pytest.mark.parametrize("arch,angle_filter", [
    ("gemma-2b", "all"), ("deepseek-v2-lite-16b", "dense_only")])
def test_train_fn_matches_the_jax_round(arch, angle_filter):
    cfg, jcfg = registry.smoke(arch), jregistry.smoke(arch)
    fn, _, _, _, meta = steps.build_train_step(
        cfg, TorchMesh((4, 1), ("data", "model")),
        shapes.InputShape("train_4k", 16, 8, "train"),
        angle_filter=angle_filter)
    k, b, tau = meta["K"], meta["B"], meta["tau"]
    assert (k, b, tau) == (4, 2, 1)
    jfc = jfl.FLConfig(**meta["flcfg"])
    tfc = tfl.FLConfig(**meta["flcfg"])
    pred = jfl.moe_dense_only_pred if angle_filter == "dense_only" else None
    jround = jax.jit(jfl.make_round_fn(
        lambda p, bt: jtr.loss_fn(p, jcfg, bt), jfc, None, pred))

    tree = jax.tree.map(np.asarray, jtr.init_params(jax.random.key(0), jcfg))
    smoothed0 = np.linspace(0.2, 1.0, k).astype(np.float32)
    count0 = np.arange(k, dtype=np.int32) % 3
    jst = jfl.init_round_state(jfc, jax.tree.map(jnp.asarray, tree))
    jst = jst._replace(angle=JAngleState(jnp.asarray(smoothed0),
                                         jnp.asarray(count0)))
    st = convert.round_state_from_numpy(tfc, tree, smoothed0, count0,
                                        device="cpu")
    rng = np.random.default_rng(3)
    sel = np.arange(k, dtype=np.int32)
    sizes = (10.0 * (1.0 + np.arange(k))).astype(np.float32)
    for r in range(2):
        toks = rng.integers(0, cfg.vocab_size,
                            (k, tau, b, 16)).astype(np.int32)
        jst, jm = jround(jst, {"tokens": jnp.asarray(toks)},
                         jnp.asarray(sel), jnp.asarray(sizes))
        st, m = fn(st, {"tokens": torch.from_numpy(toks)},
                   torch.from_numpy(sel), torch.from_numpy(sizes))
        for keys, j, t in _pairs(
                (jst.params, jst.prev_delta, jst.angle.smoothed),
                (st.params, st.prev_delta, st.angle.smoothed)):
            np.testing.assert_allclose(t.detach().float().numpy(),
                                       np.asarray(j, np.float32),
                                       err_msg=f"round {r} {keys}", **TOL)
        for key in ("loss", "theta", "weights", "divergence"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                       err_msg=f"round {r} {key}", **TOL)
        assert st.angle.count.tolist() == np.asarray(jst.angle.count).tolist()
        assert int(st.round) == int(jst.round) == r + 1


# ------------------------------------------------------ (c) the launcher


def test_launcher_resumes_bit_exactly(tmp_path):
    base = ["--arch", "gemma-2b", "--smoke", "--host-mesh", "--device",
            "cpu", "--seq", "32", "--global-batch", "2"]
    whole = train.main(base + ["--rounds", "3"])
    assert len(whole["losses"]) == 3 and np.isfinite(whole["losses"]).all()
    ckpt = str(tmp_path / "ckpt")
    half = train.main(base + ["--rounds", "2", "--ckpt", ckpt])
    assert half["losses"] == whole["losses"][:2]
    tel = str(tmp_path / "tel")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *base,
         "--rounds", "3", "--ckpt", ckpt, "--resume", "--telemetry", tel],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert any(line.startswith("resumed ") and "@ round 2" in line
               for line in lines)
    sha = [line.split()[1] for line in lines
           if line.startswith("params_sha256")]
    assert sha == [whole["params_sha256"]]
    events = sinks.load_events(os.path.join(tel, "telemetry.jsonl"))
    counts = schema.validate_events(events)
    assert counts.get("round") == 1 and counts.get("node") == 1


def test_launcher_without_host_mesh_names_item_13b(monkeypatch):
    """Off the host mesh the launcher runs on a torch.distributed world:
    with no process group and no torchrun it says how to start one."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="under torchrun"):
        train.main(["--arch", "gemma-2b", "--device", "cpu"])
