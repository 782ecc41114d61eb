"""The port's other model families against the JAX package: MoE with
MLA (deepseek-v2-lite-16b, deepseek-v2-236b), the Jamba Mamba +
attention hybrid, RWKV-6, the Whisper encoder-decoder and Qwen2-VL's
M-RoPE prefix.

Each variant is the reduced (smoke) config of its architecture, f32,
with attention_impl="flash" (the JAX package runs its Pallas kernel in
interpret mode, the port the kernel's plain version on the CPU), plus:
jamba at `scan_unroll=4` and at `stream_dtype="bfloat16"`; MoE at
`capacity_factor=0.5` (overflow really drops assignments) and at
`combine_dtype="bfloat16"`; deepseek-v2-236b with `q_lora_rank=32`
(`reduced()` zeroes it). The JAX package's params are carried across by
`convert.lm_params_from_numpy`, and both packages see the same numpy
tokens, stub vision / encoder embeddings and (Qwen2-VL) distinct
(3, B, T) M-RoPE position streams. Held: the prefill logits, aux and
cache; 4 decode steps (logits and cache); train-mode logits and aux;
`loss_fn` and its gradients.

Tolerances: logits, caches and aux at 2e-4 (tests/test_torch_lm.py);
the loss and its gradients at 1e-5 (tests/test_torch_lm_train.py), or
2e-5 where flash runs (qwen2-vl, jamba, whisper's decoder); the loss
and gradients are held in tests/test_torch_families_train.py, the
modules one by one in tests/test_torch_family_parts.py.

The two variants that store a tensor in bf16 are held at looser
tolerances: jamba's x / B / C streams at 2e-2, the reference's own
tolerance for its Mamba scan (tests/test_recurrences.py), and the MoE
combine at 5e-3, about twice its own measured error. Measured, their
prefill logits differ from the JAX package's by up to 1.0e-2 (jamba)
and 2.7e-3 (MoE) at logits of magnitude 5, their loss by 1.2e-4 and
1.2e-5. The cause is
bf16 rounding, not the port: the two packages' f32 values before the
cast differ in the last bits (another matmul summation order), which
now and then sends one element to the neighbouring bf16 value, 2^-8 of
it away, and the recurrence / the residual stream carries that on. So
these variants are also held to agree within a tenth of their own
effect: the mean gap to the JAX package against the mean change that
bf16 storage makes in the JAX package's logits (ROADMAP Queue 3).

Also: `init_cache` of each family against the reference's, and one
decode step from it; `count_params` of all ten full configs with and
without `active_only`, allocating nothing; the layout and dtypes of
`init_params`; and the init repair: `init_params`' live bytes peak at
the params plus one draw, not two copies of the model.
"""
import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core import treemath
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.config import with_changes

TOL = dict(atol=2e-4, rtol=2e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = {  # the variants that store a tensor in bf16
    "jamba-stream_bf16": dict(atol=2e-2, rtol=2e-2),  # the reference's
    # Mamba scan's (tests/test_recurrences.py)
    "moe-combine_bf16": dict(atol=5e-3, rtol=5e-3),  # its measured 2.7e-3
}
B, T, STEPS = 2, 64, 4  # T counts the vision prefix: flash needs T % 64

# variant -> (architecture, {config field: value or {subfield: value}})
VARIANTS = {
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
    "deepseek-v2-236b-q_lora_32": ("deepseek-v2-236b",
                                   {"mla": {"q_lora_rank": 32}}),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
    "jamba-scan_unroll_4": ("jamba-1.5-large-398b",
                            {"ssm": {"scan_unroll": 4}}),
    "jamba-stream_bf16": ("jamba-1.5-large-398b",
                          {"ssm": {"stream_dtype": "bfloat16"}}),
    "rwkv6-3b": ("rwkv6-3b", {}),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}),
    "whisper-small": ("whisper-small", {}),
    "moe-capacity_0.5": ("deepseek-v2-lite-16b",
                         {"moe": {"capacity_factor": 0.5}}),
    "moe-combine_bf16": ("deepseek-v2-lite-16b",
                         {"moe": {"combine_dtype": "bfloat16"}}),
}
# the variants that store a tensor in bf16, and their f32 base
BF16_VARIANTS = {"jamba-stream_bf16": "jamba-1.5-large-398b",
                 "moe-combine_bf16": "deepseek-v2-lite-16b"}
NEW_FAMILIES = ["deepseek-v2-236b", "deepseek-v2-lite-16b",
                "jamba-1.5-large-398b", "qwen2-vl-2b", "rwkv6-3b",
                "whisper-small"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread: when several test processes share
    the CPU, torch's default pool oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant: str, impl: str = "flash"):
    arch, changes = VARIANTS[variant]
    return (with_changes(jreg.smoke(arch, attention_impl=impl), changes),
            with_changes(treg.smoke(arch, attention_impl=impl), changes))


def _runs_flash(cfg) -> bool:
    return any(k == "attn" for k in cfg.block_pattern) and not cfg.mla


def tol_for(variant: str, tol=TOL):
    return BF16_TOL.get(variant, tol)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _tree_close(got, want, what, tol=TOL):
    """Every leaf of the port's tree against the same path of the JAX
    package's (numpy) tree; the two trees' paths must be the same."""
    want_paths = [tuple(getattr(k, "key", k) for k in p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(want)[0]]
    assert treemath.tree_paths(got) == want_paths, what
    for path, g, w in zip(want_paths, treemath.tree_leaves(got),
                          jax.tree.leaves(want)):
        assert tuple(g.shape) == np.shape(w), (what, path)
        assert g.dtype == convert._tensor(np.asarray(w)).dtype, (what, path)
        _close(g, w, f"{what}/{'/'.join(map(str, path))}", tol)


def _inputs(cfg, seed: int = 1):
    """Numpy tokens (B, T - P), the stub embeddings, M-RoPE position
    streams that differ (temporal / height / width), and the decode
    steps' tokens and (3, B, 1) positions."""
    rng = np.random.default_rng(seed)
    p = cfg.vision_prefix
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, T - p)).astype(np.int32)}
    if p:
        out["vision_embeds"] = (rng.normal(size=(B, p, cfg.d_model))
                                * 0.02).astype(np.float32)
    if cfg.encoder_layers:
        out["enc_embeds"] = (rng.normal(size=(B, cfg.encoder_len,
                                              cfg.d_model))
                             * 0.02).astype(np.float32)
    if cfg.rope_style == "mrope":
        t = np.arange(T)
        out["positions"] = np.stack([
            np.broadcast_to(t, (B, T)), np.broadcast_to(t // 4, (B, T)),
            np.broadcast_to(t % 4 + 3 * np.arange(B)[:, None], (B, T))
        ]).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    steps = [None] * STEPS
    if cfg.rope_style == "mrope":
        steps = [rng.integers(0, 2 * T, (3, B, 1)).astype(np.int32)
                 for _ in range(STEPS)]
    return out, feed, steps


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _extras(pos, lib):
    if pos is None:
        return {}
    return {"positions": jnp.asarray(pos) if lib == "jax"
            else torch.from_numpy(pos)}


@functools.lru_cache(maxsize=None)
def _setup(variant: str):
    """(JAX cfg, port cfg, JAX params, the port's params carried
    across)."""
    jcfg, cfg = _cfgs(variant)
    jparams = jtr.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.lm_params_from_numpy(tree, cfg,
                                                            "cpu")


@functools.lru_cache(maxsize=None)
def _jax_serve(variant: str):
    """The JAX package's prefill and decode steps."""
    jcfg, _, jparams, _ = _setup(variant)
    batch, feed, steps = _inputs(jcfg)
    logits, aux, cache = jtr.forward(jparams, jcfg, _jbatch(batch),
                                     mode="prefill", max_len=T + STEPS)
    out = {"prefill": jax.tree.map(np.asarray, (logits, aux, cache)),
           "decode": []}
    for i in range(STEPS):
        logits, cache = jtr.decode_step(jparams, jcfg, jnp.asarray(feed[i]),
                                        cache, jnp.int32(T + i),
                                        _extras(steps[i], "jax"))
        out["decode"].append(jax.tree.map(np.asarray, (logits, cache)))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_logits_aux_and_cache_match_jax(variant):
    _, cfg, _, params = _setup(variant)
    want_logits, want_aux, want_cache = _jax_serve(variant)["prefill"]
    batch, _, _ = _inputs(cfg)
    with torch.no_grad():
        logits, aux, cache = ttr.forward(params, cfg, _tbatch(batch),
                                         mode="prefill", max_len=T + STEPS)
    assert logits.shape == (B, T, cfg.vocab_size)
    _close(logits, want_logits, "prefill logits", tol_for(variant))
    _close(aux, want_aux, "aux", tol_for(variant))
    _tree_close(cache, want_cache, "prefill cache", tol_for(variant))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match_jax(variant):
    _, cfg, _, params = _setup(variant)
    want = _jax_serve(variant)
    batch, feed, steps = _inputs(cfg)
    with torch.no_grad():
        _, _, cache = ttr.forward(params, cfg, _tbatch(batch),
                                  mode="prefill", max_len=T + STEPS)
        for i in range(STEPS):
            logits, cache = ttr.decode_step(
                params, cfg, torch.from_numpy(feed[i]), cache, T + i,
                _extras(steps[i], "torch"))
            assert logits.shape == (B, 1, cfg.vocab_size)
            _close(logits, want["decode"][i][0], f"decode {i} logits",
                   tol_for(variant))
            _tree_close(cache, want["decode"][i][1], f"decode {i} cache",
                        tol_for(variant))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_logits_and_aux_match_jax(variant):
    jcfg, cfg, jparams, params = _setup(variant)
    batch, _, _ = _inputs(cfg)
    want, want_aux, want_off = jtr.forward(jparams, jcfg, _jbatch(batch),
                                           mode="train")
    with torch.no_grad():
        got, aux, off = ttr.forward(params, cfg, _tbatch(batch),
                                    mode="train")
    assert off == want_off == cfg.vision_prefix
    _close(got, want, "train logits", tol_for(variant))
    _close(aux, want_aux, "train aux", tol_for(variant))
    if cfg.moe is not None:
        assert float(aux) > 0.0


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_init_cache_then_decode_matches_jax(arch):
    """`init_cache` for every kind (MLA latents, Mamba {h, conv}, RWKV
    {S, tm_last, cm_last}, K/V with the cross K/V of enc-dec models): the
    reference's paths, shapes, dtypes and zeros; then one decode step
    from it against the JAX package's."""
    variant = {"deepseek-v2-236b": "deepseek-v2-236b-q_lora_32"}.get(arch,
                                                                    arch)
    jcfg, cfg, jparams, params = _setup(variant)
    cache = ttr.init_cache(cfg, B, 16)
    jcache = jtr.init_cache(jcfg, B, 16)
    _tree_close(cache, jax.tree.map(np.asarray, jcache), "init_cache",
                dict(atol=0, rtol=0))
    tok = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32)
    with torch.no_grad():
        logits, cache = ttr.decode_step(params, cfg, torch.from_numpy(tok),
                                        cache, 8)
    wl, wc = jtr.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(8), {})
    _close(logits, wl, "logits")
    _tree_close(cache, jax.tree.map(np.asarray, wc), "cache")


@pytest.mark.parametrize("variant", sorted(BF16_VARIANTS))
def test_bf16_variants_agree_within_a_tenth_of_their_effect(variant):
    _, cfg, _, params = _setup(variant)
    batch, _, _ = _inputs(cfg)
    want = _jax_serve(variant)["prefill"][0]
    f32 = _jax_serve(BF16_VARIANTS[variant])["prefill"][0]
    with torch.no_grad():
        got, _, _ = ttr.forward(params, cfg, _tbatch(batch),
                                mode="prefill", max_len=T + STEPS)
    gap = float(np.mean(np.abs(got.numpy() - want)))
    effect = float(np.mean(np.abs(want - f32)))
    assert gap <= effect / 10, (gap, effect)


def test_capacity_half_really_drops_assignments():
    """At capacity_factor 0.5 the prefill's MoE layers drop some of the
    top-k assignments (so the parity above covers the overflow row)."""
    _, cfg, _, params = _setup("moe-capacity_0.5")
    batch, _, _ = _inputs(cfg)
    seen = []
    real = tmoe._route

    def spy(*a):
        out = real(*a)
        seen.append(out[5])
        return out

    tmoe._route = spy
    try:
        with torch.no_grad():
            ttr.forward(params, cfg, _tbatch(batch), mode="train")
    finally:
        tmoe._route = real
    assert len(seen) == cfg.num_layers
    kept = torch.cat(seen)
    assert 0 < int((~kept).sum()) < kept.numel()


# ------------------------------------------------------- counts and init


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_count_params_matches_reference_full_config(arch, active_only):
    cfg = treg.get(arch)
    assert ttr.count_params(cfg, active_only) == jtr.count_params(
        jreg.get(arch), active_only)
    want = cfg.active_param_count() if active_only else cfg.param_count()
    assert want == ttr.count_params(cfg, active_only)


def test_full_deepseek_lite_counts_and_meta_init_allocates_nothing():
    cfg = treg.get("deepseek-v2-lite-16b")
    assert cfg.param_count() == 16_210_324_992
    meta = ttr.init_params(None, cfg, device="meta")
    leaves = treemath.tree_leaves(meta)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count()
    assert meta["blocks"]["p0"]["ffn"]["router"].dtype == torch.float32
    assert meta["blocks"]["p0"]["ffn"]["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_init_params_layout_and_dtypes_are_the_references(arch):
    """`init_params` on the CPU: the reference's paths, shapes and leaf
    dtypes (checked by `lm_params_from_numpy`), bf16 as configured, and
    every leaf finite with the reference's constants."""
    cfg = treg.smoke(arch, dtype="bfloat16")
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    convert.lm_params_from_numpy(convert.params_to_numpy(params), cfg,
                                 "cpu")
    shapes = jax.eval_shape(functools.partial(
        jtr.init_params, cfg=jreg.smoke(arch, dtype="bfloat16")),
        jax.random.key(0))
    for path, t, w in zip(treemath.tree_paths(params),
                          treemath.tree_leaves(params),
                          jax.tree.leaves(shapes)):
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        assert bool(torch.isfinite(t.float()).all()), path
    if cfg.ssm is not None:
        mixer = params["blocks"]["p0"]["mixer"]
        np.testing.assert_allclose(
            mixer["A_log"][0].numpy(),
            np.log(np.tile(np.arange(1, cfg.ssm.d_state + 1,
                                     dtype=np.float32),
                           (tmamba.d_inner(cfg), 1))))
        assert bool((mixer["D"] == 1).all())


class _LiveBytes(TorchDispatchMode):
    """Counts the bytes of every tensor that an op allocates (an output
    whose storage no input holds) while it lives, and their peak."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        held = {t.untyped_storage().data_ptr() for t in
                torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and \
                    t.untyped_storage().data_ptr() not in held:
                n = t.untyped_storage().nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_init_peak_is_the_params_plus_one_draw(arch, monkeypatch):
    """`init_params` allocates each stacked leaf once, in its dtype, and
    fills it slice by slice: its live bytes peak at the params' bytes
    plus one f32 draw of at most `_DRAW_ELEMS` (here 4,096, so that the
    experts and the embedding are drawn in several slices), far below
    the params plus one group."""
    monkeypatch.setattr(tlayers, "_DRAW_ELEMS", 4096)
    cfg = treg.smoke(arch, dtype="bfloat16")
    mode = _LiveBytes()
    with mode:
        params = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    nbytes = sum(t.numel() * t.element_size()
                 for t in treemath.tree_leaves(params))
    group = nbytes // cfg.num_pattern_groups
    assert nbytes <= mode.peak <= nbytes + 4 * 4096 + 1024, (mode.peak,
                                                           nbytes)
    assert mode.peak < nbytes + group // 8
