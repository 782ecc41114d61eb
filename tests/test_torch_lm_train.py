"""Federated training of the dense LM: the port against the JAX package.

A 2-layer dense LM (d = 64, 4 query heads over 2 KV heads, vocab 256,
f32, tied embeddings) starts from the JAX package's params, carried
across by `convert.lm_params_from_numpy`, and both packages see the same
numpy tokens (T = 64). Held, at the reference's 1e-5 (rtol and atol):

* `layers.softmax_cross_entropy`, with and without a mask;
* `transformer.loss_fn` with `loss_chunk` 0 and chunks that need
  padding, and with a `loss_mask`;
* the loss and its grads against `jax.grad`, on the xla and the flash
  attention path (the JAX package runs its Pallas kernel in interpret
  mode, the port the kernel's plain version, whose backward is the
  reference's recompute);
* one FedAdp round (K = 3, tau = 2, B = 2) of the port's flat and tree
  engines against the JAX package's flat round on injected inputs, as
  tests/test_torch_round.py does, on both attention paths;

and grads through `gqa_flash` (G < H) under `torch.func.grad` and under
`torch.func.vmap(grad)`, where the autograd Function's vmap rule folds
the vmapped dim into the batch (batched or shared k and v), against
`jax.grad` through the JAX `gqa_flash` at the kernel's f32 tolerance,
2e-5. The Function's forward must only ever see plain tensors: the
kernel's ctypes launch reads their storage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fl as jfl
from repro.core.weighting import AngleState as JAngleState
from repro.kernels import flash_attn as jfa
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.core import fl as tfl
from repro_torch.core import treemath
from repro_torch.kernels import flash_attn as tfa
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig as TConfig

TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)  # the f32 kernel's, as the reference
LM = dict(name="fl-lm-test", arch_type="dense", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
          tie_embeddings=True, dtype="float32")
K, TAU, B, T = 3, 2, 2, 64
IMPLS = ["xla", "flash"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread: when several test processes share
    the CPU, torch's default pool oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(impl, **kw):
    return (JConfig(**LM, attention_impl=impl, **kw),
            TConfig(**LM, attention_impl=impl, **kw))


def _params(seed=0):
    jcfg, tcfg = _cfgs("xla")
    tree = jax.tree.map(np.asarray, jtr.init_params(jax.random.key(seed),
                                                    jcfg))
    return tree, convert.lm_params_from_numpy(tree, tcfg, "cpu")


def _tokens(shape, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, LM["vocab_size"], size=shape).astype(np.int32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _tree_close(got, want, what, tol=TOL):
    for path, g in zip(treemath.tree_paths(got), treemath.tree_leaves(got)):
        w = want
        for key in path:
            w = w[key]
        _close(g, w, f"{what}/{'/'.join(map(str, path))}", tol)


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("mask", [None, "random", "zeros"])
def test_softmax_cross_entropy_matches_jax(mask):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(2, 5, 37))).astype(np.float32)
    labels = rng.integers(0, 37, size=(2, 5)).astype(np.int32)
    m = None if mask is None else (
        (rng.uniform(size=(2, 5)) < 0.6).astype(np.float32)
        if mask == "random" else np.zeros((2, 5), np.float32))
    want = jlayers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if m is None else jnp.asarray(m))
    got = tlayers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, f"mask={mask}")


def test_softmax_cross_entropy_takes_bf16_logits_in_f32():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(4,)).astype(np.int64)
    got = tlayers.softmax_cross_entropy(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels))
    want = jlayers.softmax_cross_entropy(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels))
    assert got.dtype == torch.float32
    _close(got, want, "bf16 logits")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("chunk", [0, 16, 40])
def test_loss_fn_matches_jax(impl, chunk):
    """loss_chunk 16 and 40 pad T - 1 = 63 predicted tokens to 64 / 80."""
    tree, params = _params()
    jcfg, tcfg = _cfgs(impl, loss_chunk=chunk)
    toks = _tokens((B, T))
    want = jtr.loss_fn(jax.tree.map(jnp.asarray, tree), jcfg,
                       {"tokens": jnp.asarray(toks)})
    got = ttr.loss_fn(params, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, f"{impl} loss_chunk={chunk}")


def test_loss_fn_with_loss_mask_matches_jax():
    tree, params = _params()
    jcfg, tcfg = _cfgs("xla")
    toks = _tokens((B, T))
    mask = (np.random.default_rng(2).uniform(size=(B, T - 1)) < 0.5
            ).astype(np.float32)
    want = jtr.loss_fn(jax.tree.map(jnp.asarray, tree), jcfg,
                       {"tokens": jnp.asarray(toks),
                        "loss_mask": jnp.asarray(mask)})
    got = ttr.loss_fn(params, tcfg, {"tokens": torch.from_numpy(toks),
                                     "loss_mask": torch.from_numpy(mask)})
    _close(got, want, "loss_mask")
    plain = ttr.loss_fn(params, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(got) - float(plain)) > 1e-4  # the mask took effect


def test_hidden_forward_then_unembed_is_the_train_forward():
    _, params = _params()
    _, tcfg = _cfgs("xla")
    batch = {"tokens": torch.from_numpy(_tokens((B, T)))}
    x, aux, off = ttr.hidden_forward(params, tcfg, batch)
    logits, aux2, off2 = ttr.forward(params, tcfg, batch, mode="train")
    assert off == off2 == 0 and float(aux) == float(aux2) == 0.0
    assert torch.equal(ttr.unembed(params, tcfg, x), logits)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_jax_grad(impl):
    tree, params = _params()
    jcfg, tcfg = _cfgs(impl)
    toks = _tokens((B, T), seed=3)
    want_loss, want = jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}))(
        jax.tree.map(jnp.asarray, tree))
    got, loss = torch.func.grad_and_value(
        lambda p: ttr.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)}))(
        params)
    _close(loss, want_loss, f"{impl} loss")
    _tree_close(got, want, f"{impl} grad")


def test_flash_grads_equal_xla_grads_in_the_port():
    _, params = _params()
    toks = torch.from_numpy(_tokens((K, B, T), seed=4))
    grads = {}
    for impl in IMPLS:
        _, tcfg = _cfgs(impl)
        grads[impl] = torch.func.vmap(torch.func.grad(
            lambda p, t: ttr.loss_fn(p, tcfg, {"tokens": t})),
            in_dims=(None, 0))(params, toks)
    for path, g, x in zip(treemath.tree_paths(grads["flash"]),
                          treemath.tree_leaves(grads["flash"]),
                          treemath.tree_leaves(grads["xla"])):
        assert g.shape == (K,) + x.shape[1:], path
        np.testing.assert_allclose(g.numpy(), x.numpy(), err_msg=str(path),
                                   **FLASH_TOL)


# ------------------------------------------------------------ the round


def _round_both(impl):
    tree, _ = _params()
    jcfg, tcfg = _cfgs(impl)
    kw = dict(num_clients=K, clients_per_round=K, local_steps=TAU,
              method="fedadp", base_lr=0.05)
    toks = _tokens((K, TAU, B, T), seed=5)
    sel = np.arange(K, dtype=np.int32)
    sizes = (10.0 * (1.0 + np.arange(K))).astype(np.float32)
    smoothed0 = np.linspace(0.2, 1.0, K).astype(np.float32)
    count0 = np.arange(K, dtype=np.int32) % 3

    jfc = jfl.FLConfig(engine="flat", **kw)
    jround = jax.jit(jfl.make_round_fn(
        lambda p, b: jtr.loss_fn(p, jcfg, b), jfc))
    jst = jfl.init_round_state(jfc, jax.tree.map(jnp.asarray, tree))
    jst = jst._replace(angle=JAngleState(jnp.asarray(smoothed0),
                                         jnp.asarray(count0)))
    jst, jm = jround(jst, {"tokens": jnp.asarray(toks)}, jnp.asarray(sel),
                     jnp.asarray(sizes))
    out = {}
    for engine in ("flat", "tree"):
        tfc = tfl.FLConfig(engine=engine, **kw)
        st = convert.round_state_from_numpy(tfc, tree, smoothed0, count0,
                                            device="cpu")
        out[engine] = tfl.make_round_fn(
            lambda p, b: ttr.loss_fn(p, tcfg, b), tfc)(
            st, {"tokens": torch.from_numpy(toks)},
            torch.from_numpy(sel.astype(np.int64)), torch.from_numpy(sizes))
    return jst, jax.device_get(jm), out


@pytest.mark.parametrize("impl", IMPLS)
def test_round_matches_jax_round(impl):
    jst, jm, out = _round_both(impl)
    for engine, (st, m) in out.items():
        what = f"{impl}/{engine}"
        _tree_close(st.params, jst.params, f"{what} params")
        _close(st.angle.smoothed, jst.angle.smoothed, f"{what} smoothed")
        assert st.angle.count.tolist() == np.asarray(jst.angle.count).tolist()
        for key in ("loss", "theta", "theta_smoothed", "weights",
                    "divergence", "lr"):
            _close(m[key], jm[key], f"{what} {key}")
        _tree_close(st.prev_delta, jst.prev_delta, f"{what} prev_delta")
        assert int(st.round) == 1


# ------------------------------------------- flash attention under grad


def _qkv(n, b, t, h, g, hd, seed=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, b, t, h, hd)).astype(np.float32),
            rng.normal(size=(n, b, t, g, hd)).astype(np.float32),
            rng.normal(size=(n, b, t, g, hd)).astype(np.float32),
            rng.normal(size=(b, t, h, hd)).astype(np.float32))


def _jax_gqa_grads(q, k, v, w, blk):
    def f(q, k, v):
        o = jfa.gqa_flash(q, k, v, causal=True, interpret=True, blk_q=blk,
                          blk_k=blk)
        return jnp.sum(o * w)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("h,g", [(4, 2), (4, 1), (2, 2)])
def test_gqa_flash_grads_match_jax_grad(h, g):
    n, b, t, hd, blk = 3, 2, 64, 32, 32
    q, k, v, w = _qkv(n, b, t, h, g, hd)
    tw = torch.from_numpy(w)

    def f(q, k, v):
        return torch.sum(tfa.gqa_flash(q, k, v, blk_q=blk, blk_k=blk) * tw)

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    # under grad alone, client 0
    want = _jax_gqa_grads(q[0], k[0], v[0], w, blk)
    got = torch.func.grad(f, argnums=(0, 1, 2))(tq[0], tk[0], tv[0])
    for name, a, e in zip("qkv", got, want):
        _close(a, e, f"grad d{name}", FLASH_TOL)
    # under vmap(grad) over n clients, k and v batched or shared
    for shared in (False, True):
        in_dims = (0, None, None) if shared else (0, 0, 0)
        kk, vv = (k[0], v[0]) if shared else (k, v)
        got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)),
                              in_dims=in_dims)(
            tq, torch.from_numpy(kk), torch.from_numpy(vv))
        for i in range(n):
            want = _jax_gqa_grads(q[i], kk if shared else k[i],
                                  vv if shared else v[i], w, blk)
            for name, a, e in zip("qkv", got, want):
                _close(a[i], e, f"vmap(grad) shared={shared} client {i} "
                       f"d{name}", FLASH_TOL)


def test_autograd_backward_matches_jax_grad():
    q, k, v, w = _qkv(1, 2, 64, 4, 2, 16, seed=7)
    tq, tk, tv = (torch.from_numpy(x[0]).requires_grad_() for x in (q, k, v))
    torch.sum(tfa.gqa_flash(tq, tk, tv, blk_q=64, blk_k=64)
              * torch.from_numpy(w)).backward()
    want = _jax_gqa_grads(q[0], k[0], v[0], w, 64)
    for name, a, e in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _close(a, e, f"backward d{name}", FLASH_TOL)


def test_flash_attention_grads_match_jax_grad():
    rng = np.random.default_rng(8)
    q, k, v, w = (rng.normal(size=(3, 64, 32)).astype(np.float32)
                  for _ in range(4))

    def jf(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, True, 32, 32, True) * w)

    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = torch.func.grad(lambda q, k, v: torch.sum(
        tfa.flash_attention(q, k, v, True, 32, 32) * torch.from_numpy(w)),
        argnums=(0, 1, 2))(*map(torch.from_numpy, (q, k, v)))
    for name, a, e in zip("qkv", got, want):
        _close(a, e, f"flash_attention d{name}", FLASH_TOL)


def test_forward_sees_plain_tensors_and_one_call_under_vmap(monkeypatch):
    """The vmap rule folds the clients into one forward call on plain
    tensors (batch K * B), whatever the nesting of transforms."""
    seen = []
    real = tfa._forward

    def spy(q, k, v, causal):
        seen.append([(torch._C._functorch.is_batchedtensor(x),
                      torch._C._functorch.is_gradtrackingtensor(x),
                      tuple(x.shape)) for x in (q, k, v)])
        return real(q, k, v, causal)

    monkeypatch.setattr(tfa, "_forward", spy)
    q, k, v, w = (torch.from_numpy(x) for x in _qkv(3, 2, 64, 4, 2, 16))
    torch.func.vmap(torch.func.grad(lambda q, k, v: torch.sum(
        tfa.gqa_flash(q, k, v, blk_q=64, blk_k=64) * w)),
        in_dims=(0, None, None))(q, k[0], v[0])
    assert seen == [[(False, False, (6, 64, 4, 16)),
                     (False, False, (6, 64, 2, 16)),
                     (False, False, (6, 64, 2, 16))]]


# -------------------------- the flat engine's CPU statistics at LM scale


@pytest.fixture(scope="module")
def lm_scale_deltas():
    """(K = 4, N = 6M) f32 rows whose magnitudes spread over e^(±2σ),
    as a round's LM deltas do (the small preset has 6,031,616 params),
    and their mean g."""
    rng = np.random.default_rng(0)
    n = 6_000_000
    scale = np.exp(2.0 * rng.normal(size=n)).astype(np.float32)
    base = (rng.normal(size=n) * scale).astype(np.float32)
    x = np.stack([base + (0.5 * rng.normal(size=n) * scale).astype(
        np.float32) for _ in range(4)])
    return torch.from_numpy(x), torch.from_numpy(x.mean(0))


def _normalised(got, terms):
    """max |got - the f64 sum| / the f64 sum of |terms| (terms (..., N))."""
    want = terms.sum(-1)
    return float(((got.double() - want).abs() / terms.abs().sum(-1)).max())


def test_plain_reductions_hold_f32_accuracy_at_lm_scale(lm_scale_deltas):
    """The kernels' plain versions sum with torch.sum: a BLAS gemv / dot
    accumulated these rows' dots to ~5e-5 of their terms, and the flat
    engine's round on the CPU then parted from the tree engine's by 4e-5
    in the FedAdp weights at the small preset."""
    from repro_torch.kernels import grad_dot, round_stats, weighted_agg

    x, g = lm_scale_deltas
    xd, gd = x.double(), g.double()
    dots, sqs, sqg = round_stats.round_stats_plain(x, g)
    errs = {"dots": _normalised(dots, xd * gd[None]),
            "sqs": _normalised(sqs, xd * xd),
            "sqg": _normalised(sqg, gd * gd),
            "batched_dot": _normalised(weighted_agg.batched_dot_plain(x, g),
                                       xd * gd[None])}
    ab, aa, bb = grad_dot.grad_dot_stats_plain(x[0], g)
    errs.update(gdot_ab=_normalised(ab, xd[0] * gd),
                gdot_aa=_normalised(aa, xd[0] * xd[0]),
                gdot_bb=_normalised(bb, gd * gd))
    assert max(errs.values()) <= 1e-6, errs
