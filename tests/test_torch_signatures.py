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
(c) `mesh` other than None raises NotImplementedError (no mesh engine in
    the port yet) through `make_round_fn`, `make_step_fn` and `FedServer`.
(d) Each shared public callable's parameter list equals the JAX
    package's after the port's recorded renames (`RENAMES`, `DROPPED`,
    `ADDED`): names, order and kinds.
"""
import inspect

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
from repro.core import weighting as jweighting
from repro.kernels import flash_attn as jflash
from repro.kernels import grad_dot as jgd
from repro.kernels import ops as jops
from repro.kernels import round_stats as jrs
from repro.kernels import weighted_agg as jwa
from repro_torch import convert
from repro_torch.core import buffer as tbuffer
from repro_torch.core import driver as tdriver
from repro_torch.core import fl as tfl
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import grad_dot as tgd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import round_stats as trs
from repro_torch.kernels import weighted_agg as twa
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
    cfg = tfl.FLConfig(num_clients=4, clients_per_round=4, local_steps=2)
    with pytest.raises(NotImplementedError, match="item 13"):
        tfl.make_round_fn(lambda p, b: 0.0, cfg, None, None, None, "mesh")
    with pytest.raises(NotImplementedError, match="item 13"):
        tfl.make_round_fn(lambda p, b: 0.0, cfg, mesh="mesh")
    with pytest.raises(NotImplementedError, match="item 13"):
        tdriver.make_step_fn(lambda p, b: 0.0, cfg, None, mesh="mesh")
    train, test = synthetic.make_image_task(num_train=400, num_test=40)
    nodes = synthetic.make_federated(train, [("iid", None)] * 4,
                                     samples_per_node=50, seed=0)
    with pytest.raises(NotImplementedError, match="item 13"):
        repro_torch.FedServer("mlr", cfg, nodes, test, 10, 0, None, "mesh",
                              device="cpu")


# ------------------------------------------------- (d) the parameter lists

# The port's recorded departures from the reference's parameter lists:
RENAMES = {"key": "gen"}  # a torch.Generator takes a jax PRNG key's place
DROPPED = {"interpret", "min_kernel_elems"}  # kernel-wrapper knobs: the
# port's wrappers launch their kernel on every CUDA tensor
ADDED = {"FedServer": [inspect.Parameter(
    "device", inspect.Parameter.KEYWORD_ONLY, default=None)]}

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
