"""The port's public callables take the JAX package's parameters, by name
and by position, so that a call written against the reference binds
every argument to the same parameter in the port.

(a) `make_round_fn(loss, fl, None, pred)`, the reference's positional
    call (`repro/launch/steps.py`), binds the angle predicate, equals the
    keyword call and the JAX round, on MLR at K = 4, tau = 2, B = 8, with
    a predicate that keeps only the bias leaf, tree and flat engines,
    injected inputs as in tests/test_torch_round.py, at 1e-5. The
    predicate moves the weights, so a call that dropped it would fail.
(b) `delta_constraint` (on the stacked deltas) and `grad_constraint` (on
    each local step's gradients), here a scale by 0.5, give the JAX
    round at 1e-5, in the parallel round and in sequential mode.
(c) The `mesh` slot of `make_round_fn`, `make_step_fn` and `FedServer`
    takes a `launch.mesh.ClientMesh` (the client-sharded engine) and
    refuses anything else with TypeError, by position and by name.
(d) Each shared public callable's parameter list equals the JAX
    package's after the port's recorded renames (`RENAMES`, `DROPPED`,
    `ADDED`): names, order and kinds. Port-only trailing keywords: `device`
    (`FedServer`, `make_host_mesh`), `param_specs` and `rows_over_data`
    (`make_round_fn`: the spec tree of params held in blocks; whether a
    sequential round's batches hold this data index's rows) and `local`
    (`make_blocked_roundtrip`: the roundtrip of a rank's blocks). The launch layer's renames: the
    module `launch/hlo_scoped.py` is `launch/optrace.py`, whose
    `analyze` reads a recorded op trace where the reference reads HLO
    text (`text` -> `trace`); a dry-run record's `compile_s` is
    `build_s`; the launcher adds `--device` and the dry run `--budget-s`
    to the reference's flags. `repro.launch.dryrun` sets XLA_FLAGS for
    512 host devices when imported, so its `run_one` is read from its
    source, never imported.
(e) The launcher's and the dry run's command-line flags are the
    reference's plus those additions.
"""
import ast
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import buffer as jbuffer
from repro.core import driver as jdriver
from repro.core import fl as jfl
from repro.core import fl_shard_map as jsm
from repro.core import treemath as jtm
from repro.core import weighting as jweighting
from repro.configs import shapes as jshapes
from repro.kernels import flash_attn as jflash
from repro.launch import hlo_scoped as jhlo_scoped
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import sharding as jsharding
from repro.kernels import grad_dot as jgd
from repro.kernels import ops as jops
from repro.kernels import round_stats as jrs
from repro.kernels import weighted_agg as jwa
from repro_torch import convert
from repro_torch.core import buffer as tbuffer
from repro_torch.core import driver as tdriver
from repro_torch.core import fl as tfl
from repro_torch.core import fl_shard_map as tsm
from repro_torch.core import treemath as ttm
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import grad_dot as tgd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import round_stats as trs
from repro_torch.kernels import weighted_agg as twa
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import optrace as toptrace
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as tsharding
from test_torch_round import METRIC_KEYS, _image

TOL = 1e-5
K, TAU, B = 4, 2, 8
SIZES = (10.0 * (1.0 + np.arange(K))).astype(np.float32)


def keep_bias(keys, leaf) -> bool:
    """The angle predicate of (a): only the bias leaf enters the angles."""
    return keys[-1] == "b"


def half_jax(tree):
    return jax.tree.map(lambda a: 0.5 * a, tree)


def half_torch(tree):
    return {name: 0.5 * a for name, a in tree.items()}


def rounds(jargs, targs, n_rounds=2, engines=("flat", "tree"), **cfg_kw):
    """The JAX round built as `jfl.make_round_fn(jloss, cfg, *jargs[0],
    **jargs[1])` and each port engine's as `tfl.make_round_fn(tloss, cfg,
    *targs[0], **targs[1])` (each a function of the problem's losses),
    from the same params and angle state over the same injected inputs.
    Returns [(JAX state, JAX metrics, {engine: (state, metrics)})] a
    round."""
    params, batches, jloss, tloss = _image("mlr", K, tau=TAU, b=B)
    kw = dict(num_clients=K, clients_per_round=K, local_steps=TAU,
              base_lr=0.05, **cfg_kw)
    smoothed0 = np.linspace(0.2, 1.0, K).astype(np.float32)
    count0 = np.arange(K, dtype=np.int32) % 3
    jengine = "flat" if kw.get("mode", "parallel") == "parallel" else "tree"
    jcfg = jfl.FLConfig(engine=jengine, **kw)
    jround = jax.jit(jfl.make_round_fn(jloss, jcfg, *jargs[0], **jargs[1]))
    jst = jfl.init_round_state(jcfg, jax.tree.map(jnp.asarray, params))
    jst = jst._replace(angle=jweighting.AngleState(jnp.asarray(smoothed0),
                                                   jnp.asarray(count0)))
    tcfgs = {e: tfl.FLConfig(engine=e, **kw) for e in engines}
    trounds = {e: tfl.make_round_fn(tloss, c, *targs[0], **targs[1])
               for e, c in tcfgs.items()}
    tst = {e: convert.round_state_from_numpy(c, params, smoothed0, count0,
                                             device="cpu")
           for e, c in tcfgs.items()}
    sel = np.arange(K)
    out = []
    for r in range(n_rounds):
        xb, yb = batches(r)
        jst, jm = jround(jst, (jnp.asarray(xb), jnp.asarray(yb)),
                         jnp.asarray(sel, jnp.int32), jnp.asarray(SIZES))
        tm = {}
        for e, fn in trounds.items():
            tst[e], m = fn(tst[e], (torch.from_numpy(xb),
                                    torch.from_numpy(yb)),
                           torch.from_numpy(sel), torch.from_numpy(SIZES))
            tm[e] = (tst[e], m)
        out.append((jst, jax.device_get(jm), tm))
    return out


def assert_matches(out, tol=TOL):
    for r, (jst, jm, tm) in enumerate(out):
        for e, (st, m) in tm.items():
            msg = f"round {r} {e}"
            got = convert.params_to_numpy(st.params)
            for name, want in jst.params.items():
                np.testing.assert_allclose(got[name], np.asarray(want),
                                           rtol=tol, atol=tol,
                                           err_msg=f"{msg} params {name}")
            np.testing.assert_allclose(st.angle.smoothed.numpy(),
                                       np.asarray(jst.angle.smoothed),
                                       rtol=tol, atol=tol, err_msg=msg)
            for key in METRIC_KEYS:
                np.testing.assert_allclose(m[key].numpy(), jm[key],
                                           rtol=tol, atol=tol,
                                           err_msg=f"{msg} {key}")


# ------------------------------------------- (a) the positional predicate


def test_positional_angle_pred_is_the_angle_pred():
    positional = ((None, keep_bias), {})
    out = rounds(positional, positional)
    assert_matches(out)
    keyword = rounds(((), dict(angle_pred=keep_bias)),
                     ((), dict(angle_pred=keep_bias)))
    for (_, _, tm), (_, _, tk) in zip(out, keyword):
        for e in tm:
            for key in METRIC_KEYS:
                assert torch.equal(tm[e][1][key], tk[e][1][key]), (e, key)
    # the predicate matters here: without it the weights move by far more
    # than the tolerance, so a call that dropped it fails above
    unfiltered = rounds(((), {}), ((), {}), engines=("flat",))
    w_pred = out[0][2]["flat"][1]["weights"].numpy()
    w_all = unfiltered[0][2]["flat"][1]["weights"].numpy()
    assert np.max(np.abs(w_pred - w_all)) > 100 * TOL


# ------------------------------------ (b) delta and gradient constraints


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_constraints_match_jax(mode):
    """A scale by 0.5 on the stacked deltas and on every step's gradients:
    the round equals the JAX round (sequential mode, as the reference,
    takes the gradient constraint only)."""
    jargs = ((half_jax, None, half_jax), {})
    targs = ((half_torch, None, half_torch), {})
    engines = ("flat", "tree") if mode == "parallel" else ("tree",)
    out = rounds(jargs, targs, engines=engines, mode=mode)
    assert_matches(out)
    plain = rounds(((), {}), ((), {}), engines=engines[:1], mode=mode)
    p_half = out[-1][2][engines[0]][0].params["w"]
    p_plain = plain[-1][2][engines[0]][0].params["w"]
    assert not torch.allclose(p_half, p_plain, rtol=TOL, atol=TOL)


def test_grad_constraint_sees_every_step():
    seen = []

    def record(g):
        seen.append(sorted(g))
        return g

    params = {"w": torch.zeros(3), "b": torch.zeros(())}
    batches = (torch.ones(5, 2, 3), torch.ones(5, 2))

    def loss(p, b):
        x, y = b
        return torch.mean((x @ p["w"] + p["b"] - y) ** 2)

    tfl.local_update(loss, params, batches, 0.1, grad_constraint=record)
    assert seen == [["b", "w"]] * 5


# -------------------------------------------------------------- (c) mesh


def test_mesh_is_refused():
    """A mesh that is not a ClientMesh is refused; a ClientMesh is taken
    in the same slot, by position and by name."""
    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=2,
                       engine="flat_sharded")
    train, test = synthetic.make_image_task(num_train=400, num_test=40)
    nodes = synthetic.make_federated(train, [("iid", None)] * 4,
                                     samples_per_node=50, seed=0)
    host = repro_torch.make_host_mesh("cpu")
    for mesh, ok in (("mesh", False), (host, True)):
        calls = (
            lambda: tfl.make_round_fn(lambda p, b: 0.0, cfg, None, None,
                                      None, mesh),
            lambda: tfl.make_round_fn(lambda p, b: 0.0, cfg, mesh=mesh),
            lambda: tdriver.make_step_fn(lambda p, b: 0.0, cfg, None,
                                         mesh=mesh),
            lambda: repro_torch.FedServer("mlr", cfg, nodes, test, 10, 0,
                                          None, mesh, device="cpu"))
        for call in calls:
            if ok:
                call()
            else:
                with pytest.raises(TypeError, match="ClientMesh"):
                    call()
    server = repro_torch.FedServer("mlr", cfg, nodes, test, 10, 0, None,
                                   host)
    assert server.mesh is host and server.device == torch.device("cpu")


# ------------------------------------------------- (d) the parameter lists

# The port's recorded departures from the reference's parameter lists:
RENAMES = {"key": "gen",  # a torch.Generator takes a jax PRNG key's place
           "text": "trace"}  # optrace.analyze reads an op trace, not HLO
DROPPED = {"interpret", "min_kernel_elems"}  # kernel-wrapper knobs: the
# port's wrappers launch their kernel on every CUDA tensor
ADDED = {"FedServer": [inspect.Parameter(
    "device", inspect.Parameter.KEYWORD_ONLY, default=None)],
    "make_host_mesh": [inspect.Parameter(
        "device", inspect.Parameter.POSITIONAL_OR_KEYWORD, default=None)],
    # the spec tree of params held in blocks: the reference's partitioner
    # reads the params' shardings instead (tensor-parallel execution)
    "make_round_fn": [inspect.Parameter(
        "param_specs", inspect.Parameter.KEYWORD_ONLY, default=None),
        # whether a sequential (FSDP) round's batches hold this data
        # index's rows: the partitioner reads the batch's sharding
        inspect.Parameter("rows_over_data", inspect.Parameter.KEYWORD_ONLY,
                          default=True)],
    # the tensor-parallel tree engine's roundtrip of this rank's blocks
    "fl_shard_map.make_blocked_roundtrip": [inspect.Parameter(
        "local", inspect.Parameter.KEYWORD_ONLY, default=False)]}

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _source_function(path: str, name: str):
    """A stub with the parameter list of function `name` in the source
    file `path`, made without importing the file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    node.body, node.decorator_list, node.returns = [ast.Pass()], [], None
    args = node.args
    for a in args.posonlyargs + args.args + args.kwonlyargs + [
            args.vararg, args.kwarg]:
        if a is not None:
            a.annotation = None
    ns: dict = {}
    exec(compile(ast.fix_missing_locations(ast.Module([node], [])), path,
                 "exec"), ns)
    return ns[name]


JDRYRUN = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")

SHARED = {
    "make_round_fn": (jfl.make_round_fn, tfl.make_round_fn),
    "make_step_fn": (jdriver.make_step_fn, tdriver.make_step_fn),
    "FedServer": (repro.FedServer.__init__, repro_torch.FedServer.__init__),
    "init_round_state": (jfl.init_round_state, tfl.init_round_state),
    "local_update": (jfl.local_update, tfl.local_update),
    "select_clients": (jdriver.select_clients, tdriver.select_clients),
    "select_clients_avoiding": (jdriver.select_clients_avoiding,
                                tdriver.select_clients_avoiding),
    "epoch_batches": (jdriver.epoch_batches, tdriver.epoch_batches),
    "draw_arrivals": (jbuffer.draw_arrivals, tbuffer.draw_arrivals),
    "round_stats": (jrs.round_stats, trs.round_stats),
    "round_stats_q": (jrs.round_stats_q, trs.round_stats_q),
    "round_stats_q4": (jrs.round_stats_q4, trs.round_stats_q4),
    "weighted_agg": (jwa.weighted_agg, twa.weighted_agg),
    "weighted_agg_q": (jwa.weighted_agg_q, twa.weighted_agg_q),
    "weighted_agg_q4": (jwa.weighted_agg_q4, twa.weighted_agg_q4),
    "batched_dot": (jwa.batched_dot, twa.batched_dot),
    "grad_dot_stats": (jgd.grad_dot_stats, tgd.grad_dot_stats),
    "flash_attention": (jflash.flash_attention, tflash.flash_attention),
    "gqa_flash": (jflash.gqa_flash, tflash.gqa_flash),
    "tree_dot_and_norms": (jops.tree_dot_and_norms, tops.tree_dot_and_norms),
    "tree_vdot_batched": (jops.tree_vdot_batched, tops.tree_vdot_batched),
    "tree_weighted_sum": (jops.tree_weighted_sum, tops.tree_weighted_sum),
    "tree_ravel_stacked": (jtm.tree_ravel_stacked, ttm.tree_ravel_stacked),
    "make_host_mesh": (jmesh.make_host_mesh, tmesh.make_host_mesh),
    "make_production_mesh": (jmesh.make_production_mesh,
                             tmesh.make_production_mesh),
    **{f"shapes.{name}": (getattr(jshapes, name), getattr(tshapes, name))
       for name in ("needs_swa_for_long", "config_for_shape",
                    "token_batch_specs", "cache_specs", "decode_specs")},
    **{f"sharding.{name}": (getattr(jsharding, name),
                            getattr(tsharding, name))
       for name in ("_leaf_spec", "param_pspecs", "param_shardings",
                    "batch_axes", "shard_batch_dim", "replicated",
                    "set_constraint_mesh", "constrain")},
    **{f"steps.{name}": (getattr(jsteps, name), getattr(tsteps, name))
       for name in ("fl_mode_for", "_replicate_extra", "params_sds",
                    "build_train_step", "build_prefill_step", "_pos_shard",
                    "_cache_shardings", "build_decode_step", "build_step")},
    "dryrun.run_one": (_source_function(JDRYRUN, "run_one"),
                       tdryrun.run_one),
    "optrace.analyze": (jhlo_scoped.analyze, toptrace.analyze),
    **{f"fl_shard_map.{name}": (getattr(jsm, name), getattr(tsm, name))
       for name in ("client_axis_size", "model_axis_size",
                    "flat_client_sharding", "make_round_ops",
                    "make_round_ops_2d", "make_blocked_roundtrip",
                    "make_buffered_flush_ops", "fedadp_aggregate",
                    "_fedadp_aggregate_flat", "_fedadp_aggregate_flat_2d",
                    "_shard_agg", "_shard_stats")},
    **{f"treemath.{name}": (getattr(jtm, name), getattr(ttm, name))
       for name in ("tree_dot", "tree_dot_and_norms", "tree_zeros_like",
                    "tree_cast", "global_norm", "BlockedLayout",
                    "blocked_layout", "blocked_ravel_local", "blocked_split",
                    "blocked_segment_mask")},
}


def _params(fn):
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(SHARED))
def test_parameters_are_the_references(name):
    jfn, tfn = SHARED[name]
    want = [(RENAMES.get(n, n), kind) for n, kind in _params(jfn)
            if n not in DROPPED]
    want += [(p.name, p.kind) for p in ADDED.get(name, [])]
    assert _params(tfn) == want


def test_the_reference_positional_round_call_binds_alike():
    """`make_round_fn(loss, fl, None, pred)` binds `pred` to `angle_pred`
    in both packages."""
    for fn in (jfl.make_round_fn, tfl.make_round_fn):
        bound = inspect.signature(fn).bind("loss", "fl", None, keep_bias)
        assert bound.arguments["angle_pred"] is keep_bias
        assert "arrival_fn" not in bound.arguments


# ------------------------------------------------ (e) the command lines

_FLAG = re.compile(r"add_argument\(\s*\"(--[\w-]+)\"")


def _flags(*parts) -> list:
    with open(os.path.join(ROOT, "src", *parts)) as f:
        return _FLAG.findall(f.read())


@pytest.mark.parametrize("module,added", [("train.py", ["--device"]),
                                          ("dryrun.py", ["--budget-s"])])
def test_command_line_flags_are_the_references(module, added):
    want = _flags("repro", "launch", module)
    assert len(want) >= 10
    assert _flags("repro_torch", "launch", module) == want + added
