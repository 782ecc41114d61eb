"""The port's dense LM serving path against the JAX package.

For each dense architecture of the registry (reduced: 2 layers, f32),
the JAX package's params are carried across by
`convert.lm_params_from_numpy`, and the same numpy tokens go through both
packages: the prefill logits and cache, then 4 decode steps (logits and
cache), then `launch.serve.generate`'s greedy token ids against the
flow of `examples/serve_decode.py`. Both attention paths are held:
"flash" (the JAX package runs its Pallas kernel in interpret mode, the
port the kernel's plain version on the CPU) and "xla" (einsum). The
tolerance is the reference's own flash-vs-xla model tolerance,
atol = rtol = 2e-4 (tests/test_flash_attn.py); token ids must be equal.

Also: train-mode logits, decode from `init_cache`, the configs read the
same in both packages, `count_params` equals
the reference's for the full configs (analytic, nothing allocated), the
building blocks match `repro.models.layers`, the sliding-window ring and
the query-chunked path match, bf16 params carry across bit for bit, and
configs outside the dense family raise NotImplementedError.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr

DENSE = ["gemma-2b", "granite-20b", "minitron-4b", "starcoder2-15b"]
IMPLS = ["flash", "xla"]
TOL = dict(atol=2e-4, rtol=2e-4)
B, T, STEPS = 2, 64, 4


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


def _tree_close(got, want, what: str) -> None:
    paths = sorted(got)
    assert paths == sorted(want), what
    for k in paths:
        if isinstance(got[k], dict):
            _tree_close(got[k], want[k], f"{what}/{k}")
        else:
            _close(got[k], want[k], f"{what}/{k}")


def _pair(arch: str, impl: str, **overrides):
    """(cfg, JAX cfg, port params, JAX params) of the reduced arch."""
    jcfg = jreg.smoke(arch, attention_impl=impl, **overrides)
    cfg = treg.smoke(arch, attention_impl=impl, **overrides)
    jparams = jtr.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, convert.lm_params_from_numpy(tree, cfg, "cpu"), jparams


def _tokens(cfg, seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, impl: str, **overrides):
    """The JAX package's prefill, decode steps (on fixed tokens) and
    greedy ids for the reduced arch."""
    _, jcfg, _, jparams = _pair(arch, impl, **overrides)
    prompt = _tokens(jcfg, 1, (B, T))
    feed = _tokens(jcfg, 2, (STEPS, B, 1))
    max_len = T + STEPS
    prefill = jax.jit(lambda p, b: jtr.forward(p, jcfg, b, mode="prefill",
                                               max_len=max_len))
    decode = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, jcfg, t, c,
                                                          pos, {}))
    logits, _, cache = prefill(jparams, {"tokens": jnp.asarray(prompt)})
    out = {"prefill": (logits, cache), "decode": []}
    c = cache
    for i in range(STEPS):
        lg, c = decode(jparams, jnp.asarray(feed[i]), c, jnp.int32(T + i))
        out["decode"].append((lg, c))
    # serve_decode's greedy flow
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    ids, c = [tok], cache
    for i in range(STEPS - 1):
        lg, c = decode(jparams, tok, c, jnp.int32(T + i))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        ids.append(tok)
    out["ids"] = np.asarray(jnp.concatenate(ids, axis=1))
    return out


def _check_prefill_and_decode(arch, impl, **overrides):
    cfg, _, params, _ = _pair(arch, impl, **overrides)
    want = _jax_run(arch, impl, **overrides)
    prompt = torch.from_numpy(_tokens(cfg, 1, (B, T)))
    feed = _tokens(cfg, 2, (STEPS, B, 1))
    with torch.no_grad():
        logits, aux, cache = ttr.forward(params, cfg, {"tokens": prompt},
                                         mode="prefill", max_len=T + STEPS)
        assert float(aux) == 0.0
        _close(logits, want["prefill"][0], "prefill logits")
        _tree_close(cache, jax.tree.map(np.asarray, want["prefill"][1]),
                    "prefill cache")
        for i in range(STEPS):
            lg, cache = ttr.decode_step(params, cfg,
                                        torch.from_numpy(feed[i]), cache,
                                        T + i)
            wl, wc = want["decode"][i]
            assert lg.shape == (B, 1, cfg.vocab_size)
            _close(lg, wl, f"decode {i} logits")
            _tree_close(cache, jax.tree.map(np.asarray, wc),
                        f"decode {i} cache")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, impl):
    _check_prefill_and_decode(arch, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_generate_matches_jax(arch, impl):
    cfg, _, params, _ = _pair(arch, impl)
    prompt = torch.from_numpy(_tokens(cfg, 1, (B, T)))
    ids = serve.generate(params, cfg, prompt, STEPS)
    assert ids.shape == (B, STEPS)
    np.testing.assert_array_equal(ids.numpy(), _jax_run(arch, impl)["ids"])


def test_sliding_window_ring_matches_jax():
    """Prefill longer than the window (the rolled ring), then decode
    steps that wrap around it."""
    _check_prefill_and_decode("starcoder2-15b", "xla", sliding_window=16)


def test_query_chunked_attention_matches_jax():
    _check_prefill_and_decode("minitron-4b", "xla", q_chunk=16)


@pytest.mark.parametrize("arch", DENSE)
def test_count_params_matches_reference_full_config(arch):
    assert ttr.count_params(treg.get(arch)) == jtr.count_params(
        jreg.get(arch))


def test_full_gemma_has_2_5b_params():
    n = treg.get("gemma-2b").param_count()
    assert 2_500_000_000 < n < 2_510_000_000


def test_configs_read_the_same_in_both_packages():
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    for name in jreg.ARCHS:
        for get in ("get", "smoke"):
            want = dataclasses.asdict(getattr(jreg, get)(name))
            assert dataclasses.asdict(getattr(treg, get)(name)) == want
    assert treg.get("gemma-2b").tdtype == torch.bfloat16
    assert treg.smoke("gemma-2b").tdtype == torch.float32


@pytest.mark.parametrize("arch", sorted(set(jreg.ARCHS) - set(DENSE)))
def test_other_families_raise_not_implemented(arch):
    cfg = treg.smoke(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.count_params(cfg)


def test_building_blocks_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 4, 64)).astype(np.float32)
    h = rng.normal(size=(2, 8, 256)).astype(np.float32) * 3
    p_ln = {"scale": rng.normal(size=256).astype(np.float32),
            "bias": rng.normal(size=256).astype(np.float32)}
    tt = torch.from_numpy
    for p in (p_ln, {"scale": p_ln["scale"]}):
        _close(tlayers.norm_apply({k: tt(v) for k, v in p.items()}, tt(h)),
               jlayers.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(h)), "norm")
    mlp = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
           (("w_gate", (256, 512)), ("w_up", (256, 512)),
            ("w_down", (512, 256)))}
    for kind in ("swiglu", "geglu", "gelu", "relu_sq"):
        _close(tlayers.mlp_apply({k: tt(v) for k, v in mlp.items()}, tt(h),
                                 kind),
               jlayers.mlp_apply({k: jnp.asarray(v) for k, v in mlp.items()},
                                 jnp.asarray(h), kind), f"mlp {kind}")
    pos = np.arange(8)[None].repeat(2, 0) + 5
    tc, ts = tlayers.rope_cos_sin(tt(pos), 64, 10000.0)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 64, 10000.0)
    _close(tc, jc, "cos")
    _close(ts, js, "sin")
    _close(tlayers.rope_apply(tt(x), tc, ts),
           jlayers.rope_apply(jnp.asarray(x), jc, js), "rope")
    # jax.nn.gelu is the tanh approximation; torch's default is exact
    one = torch.ones(1)
    assert abs(float(torch.nn.functional.gelu(one, approximate="tanh"))
               - float(jax.nn.gelu(jnp.ones(1))[0])) < 1e-6


def test_bf16_params_carry_across_bit_for_bit():
    jcfg = jreg.smoke("gemma-2b", dtype="bfloat16")
    cfg = treg.smoke("gemma-2b", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jtr.init_params(jax.random.key(0), jcfg))
    params = convert.lm_params_from_numpy(tree, cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    back = convert.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_lm_params_from_numpy_names_a_wrong_leaf():
    cfg = treg.smoke("starcoder2-15b")
    tree = convert.params_to_numpy(
        ttr.init_params(torch.Generator().manual_seed(0), cfg))
    tree["blocks"]["p0"]["mixer"]["wq"] = tree["blocks"]["p0"]["mixer"][
        "wq"][:, :, :-1]
    with pytest.raises(ValueError, match="blocks/p0/mixer/wq"):
        convert.lm_params_from_numpy(tree, cfg, "cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="paths differ"):
        convert.lm_params_from_numpy(tree, cfg, "cpu")


def test_init_cache_then_decode_matches_jax():
    """Decode from a zero cache (the reference's launch/serve.py flow)."""
    cfg, jcfg, params, jparams = _pair("granite-20b", "xla")
    cache = ttr.init_cache(cfg, B, 16)
    jcache = jtr.init_cache(jcfg, B, 16)
    for a, b in zip(jax.tree.leaves(jcache), [cache["p0"]["k"],
                                              cache["p0"]["v"]]):
        assert tuple(b.shape) == a.shape and not bool(b.any())
        assert b.dtype == torch.float32 and a.dtype == jnp.float32
    tok = _tokens(cfg, 3, (B, 1))
    with torch.no_grad():
        lg, cache = ttr.decode_step(params, cfg, torch.from_numpy(tok),
                                    cache, 8)
    wl, wc = jtr.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(8))
    _close(lg, wl, "logits")
    _tree_close(cache, jax.tree.map(np.asarray, wc), "cache")


@pytest.mark.parametrize("impl", IMPLS)
def test_train_mode_logits_match_jax(impl):
    cfg, jcfg, params, jparams = _pair("gemma-2b", impl)
    prompt = _tokens(cfg, 4, (B, T))
    want, _, woff = jtr.forward(jparams, jcfg, {"tokens": jnp.asarray(prompt)},
                                mode="train")
    with torch.no_grad():
        got, aux, off = ttr.forward(params, cfg,
                                    {"tokens": torch.from_numpy(prompt)},
                                    mode="train")
    assert off == woff == 0 and float(aux) == 0.0
    _close(got, want, "train logits")
