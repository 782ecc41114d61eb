"""The modules of the port's other model families one by one against
the JAX functions, on the reduced configs, f32, at 2e-4
(tests/test_torch_lm.py's tolerance): `moe_apply` at train and decode
shapes (capacity overflow, the bf16 combine, no shared expert, top-1)
and which assignments capacity drops; `mla_forward` / `mla_decode` with
and without the q-LoRA branch; `mamba_forward` (plain, `scan_unroll=4`,
bf16 streams) and a decode step through its conv prefix; `_wkv_chunked`
over the whole clamped log-decay range, `time_mix`, `time_mix_decode`
and `channel_mix`; `cross_attn_kv` / `cross_attn_apply`;
`mrope_cos_sin` and `groupnorm_heads`. Params come from the JAX init
functions, carried across by `convert.params_from_numpy`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.config import with_changes
from test_torch_families import _close, _tree_close


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread: when several test processes share
    the CPU, torch's default pool oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.params_from_numpy(_np_tree(tree), "cpu")


@pytest.mark.parametrize("changes", [{}, {"capacity_factor": 0.5},
                                     {"combine_dtype": "bfloat16"},
                                     {"num_shared": 0, "top_k": 1}])
@pytest.mark.parametrize("tokens", [(2, 16), (4, 1)])
def test_moe_apply_matches_jax(changes, tokens):
    """Train / prefill shape and decode's (B, 1, d), where C = 8."""
    jcfg = with_changes(jreg.smoke("deepseek-v2-lite-16b"), {"moe": changes})
    cfg = with_changes(treg.smoke("deepseek-v2-lite-16b"), {"moe": changes})
    jp = jmoe.moe_init(jax.random.key(3), jcfg)
    x = np.random.default_rng(0).normal(
        size=tokens + (cfg.d_model,)).astype(np.float32)
    wy, waux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    y, aux = tmoe.moe_apply(_t(jp), cfg, torch.from_numpy(x))
    _close(y, wy, "moe y")
    _close(aux, waux, "moe aux")
    if tokens[1] == 1:
        assert tmoe._capacity(tokens[0], cfg.moe) == 8


def test_moe_route_drops_the_reference_assignments():
    """The kept / dropped assignments are the reference's: token-major
    within an expert, overflow to row E*C."""
    cfg = with_changes(treg.smoke("deepseek-v2-lite-16b"),
                 {"moe": {"capacity_factor": 0.25}})
    rng = np.random.default_rng(5)
    p = {"router": torch.from_numpy(rng.normal(size=(cfg.d_model, 4))
                                    .astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(64, cfg.d_model))
                         .astype(np.float32))
    _, flat_e, stok, _, slot, keep, C = tmoe._route(p, cfg, x)
    # by hand: walk the assignments token-major, count per expert
    seen, want_keep = {}, {}
    for i, e in enumerate(flat_e.tolist()):
        n = seen.get(e, 0)
        seen[e] = n + 1
        want_keep[(i // cfg.moe.top_k, e)] = n < C
    got = {(int(t), int(e)): bool(k) for t, e, k in
           zip(stok, flat_e[torch.argsort(flat_e, stable=True)], keep)}
    assert got == want_keep and not all(got.values())
    assert bool((slot[~keep] == 4 * C).all())


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_forward_and_decode_match_jax(q_lora):
    changes = {"mla": {"q_lora_rank": q_lora}}
    jcfg = with_changes(jreg.smoke("deepseek-v2-236b"), changes)
    cfg = with_changes(treg.smoke("deepseek-v2-236b"), changes)
    jp = jmla.mla_init(jax.random.key(4), jcfg)
    p = _t(jp)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    rd = cfg.mla.rope_head_dim
    pos = np.arange(24)[None].repeat(2, 0)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), rd, cfg.rope_theta)
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), rd, cfg.rope_theta)
    wy, wcache = jmla.mla_forward(jp, jcfg, jnp.asarray(x), jc, js,
                                  return_cache=True, max_len=32)
    y, cache = tmla.mla_forward(p, cfg, torch.from_numpy(x), tc, ts,
                                return_cache=True, max_len=32)
    _close(y, wy, "mla_forward y")
    _tree_close(cache, _np_tree(wcache), "mla cache")
    jc1, js1 = jlayers.rope_cos_sin(jnp.full((2, 1), 24), rd, cfg.rope_theta)
    tc1, ts1 = tlayers.rope_cos_sin(torch.full((2, 1), 24), rd,
                                    cfg.rope_theta)
    wy, wcache = jmla.mla_decode(jp, jcfg, jnp.asarray(x1), wcache,
                                 jnp.int32(24), jc1, js1)
    y, cache = tmla.mla_decode(p, cfg, torch.from_numpy(x1), cache, 24,
                               tc1, ts1)
    _close(y, wy, "mla_decode y")
    _tree_close(cache, _np_tree(wcache), "mla decode cache")


@pytest.mark.parametrize("ssm", [{}, {"scan_unroll": 4},
                                 {"stream_dtype": "bfloat16"}])
def test_mamba_forward_matches_jax(ssm):
    jcfg = with_changes(jreg.smoke("jamba-1.5-large-398b"), {"ssm": ssm})
    cfg = with_changes(treg.smoke("jamba-1.5-large-398b"), {"ssm": ssm})
    jp = jmamba.mamba_init(jax.random.key(5), jcfg)
    p = _t(jp)
    assert p["A_log"].dtype == p["dt_b"].dtype == p["D"].dtype == \
        torch.float32
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    wy, wst = jmamba.mamba_forward(jp, jcfg, jnp.asarray(x), None)
    y, st = tmamba.mamba_forward(p, cfg, torch.from_numpy(x), None)
    _close(y, wy, "mamba y")
    _tree_close(st, _np_tree(wst), "mamba state")
    # one decode step from that state through the conv prefix buffer
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    wy, wst = jmamba.mamba_forward(jp, jcfg, jnp.asarray(x1), wst)
    y, st = tmamba.mamba_forward(p, cfg, torch.from_numpy(x1), st)
    _close(y, wy, "mamba decode y")
    _tree_close(st, _np_tree(wst), "mamba decode state")


def test_rwkv_wkv_and_time_mix_decode_match_jax():
    jcfg, cfg = jreg.smoke("rwkv6-3b"), treg.smoke("rwkv6-3b")
    rng = np.random.default_rng(3)
    e, H, L = cfg.rwkv.head_dim, cfg.d_model // cfg.rwkv.head_dim, 8
    shape = (2, 3, L, H, e)
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    # log-decays over the whole clamped range, down to -40 / L
    logw = -rng.uniform(1e-6, 40.0 / L, size=shape).astype(np.float32)
    u = rng.normal(size=(H, e)).astype(np.float32)
    s0 = rng.normal(size=(2, H, e, e)).astype(np.float32)
    wout, ws = jrwkv._wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u, s0)))
    out, s = trwkv.wkv_chunked(*map(torch.from_numpy,
                                     (r, k, v, logw, u, s0)))
    _close(out, wout, "wkv out")
    _close(s, ws, "wkv state")

    jp = jrwkv.rwkv_init(jax.random.key(6), jcfg)
    p = _t(jp)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    wy, wst = jrwkv.time_mix(jp, jcfg, jnp.asarray(x), None)
    y, st = trwkv.time_mix(p, cfg, torch.from_numpy(x), None)
    _close(y, wy, "time_mix y")
    _tree_close(st, _np_tree(wst), "time_mix state")
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    wy, wst = jrwkv.time_mix_decode(jp, jcfg, jnp.asarray(x1), wst)
    y, st = trwkv.time_mix_decode(p, cfg, torch.from_numpy(x1), st)
    _close(y, wy, "time_mix_decode y")
    _tree_close(st, _np_tree(wst), "time_mix_decode state")
    wy, wlast = jrwkv.channel_mix(jp, jnp.asarray(x), jnp.asarray(x1[:, 0]))
    y, last = trwkv.channel_mix(p, torch.from_numpy(x),
                                torch.from_numpy(x1[:, 0]))
    _close(y, wy, "channel_mix y")
    _close(last, wlast, "channel_mix last")


def test_rwkv_time_mix_refuses_t_off_the_chunk():
    cfg = treg.smoke("rwkv6-3b")
    p = tlayers.make(trwkv.rwkv_init(cfg), torch.Generator().manual_seed(0),
                     "cpu")
    with pytest.raises(AssertionError, match="chunk_len"):
        trwkv.time_mix(p, cfg, torch.zeros((1, 12, cfg.d_model)), None)


def test_cross_attention_matches_jax():
    jcfg, cfg = jreg.smoke("whisper-small"), treg.smoke("whisper-small")
    jp = jattn.cross_attn_init(jax.random.key(7), jcfg)
    p = _t(jp)
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(2, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    wkv = jattn.cross_attn_kv(jp, jcfg, jnp.asarray(enc))
    kv = tattn.cross_attn_kv(p, cfg, torch.from_numpy(enc))
    _tree_close(kv, _np_tree(wkv), "cross kv")
    _close(tattn.cross_attn_apply(p, cfg, torch.from_numpy(x), kv),
           jattn.cross_attn_apply(jp, jcfg, jnp.asarray(x), wkv),
           "cross_attn_apply")
    # attn_init's d_in
    assert tuple(tlayers.make(tattn.attn_init(cfg, d_in=96), None,
                              "meta")["wq"].shape) == (96, cfg.d_model)


def test_mrope_and_groupnorm_heads_match_jax():
    rng = np.random.default_rng(8)
    pos = rng.integers(0, 500, size=(3, 2, 7)).astype(np.int32)
    for hd, secs in ((64, (8, 12, 12)), (128, (16, 24, 24))):
        wc, ws = jlayers.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, secs)
        c, s = tlayers.mrope_cos_sin(torch.from_numpy(pos), hd, 1e6, secs)
        _close(c, wc, "mrope cos")
        _close(s, ws, "mrope sin")
    x = (rng.normal(size=(2, 5, 4, 32)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.normal(size=(4, 32)).astype(np.float32)
                   for _ in range(2))
    _close(tlayers.groupnorm_heads(*map(torch.from_numpy, (x, scale, bias))),
           jlayers.groupnorm_heads(*map(jnp.asarray, (x, scale, bias))),
           "groupnorm_heads")
