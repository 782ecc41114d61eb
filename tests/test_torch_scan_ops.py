"""The recurrent blocks' custom ops: `repro_torch::selective_scan`
(`models/mamba.py`) and `repro_torch::wkv_chunked` (`models/rwkv6.py`),
each with its backward op, against their loop forms (the port's code
before the ops: a Python loop over the steps, or over the chunks,
differentiated by autograd) and against the JAX package.

Held: `torch.library.opcheck` on all four ops (the forward with and
without grads, the backward with a shared and a per-row parameter); the
forward bit for bit the loop form's; the gradients of every input under
plain autograd, `torch.func.grad` and `vmap(grad)` (each client its own
A or u, folded into the rows) and inside `models/recompute.py`'s rerun,
equal to the loop form's at 1e-6 of each gradient's largest entry (the
backward sums the same terms in another order); the K clients of
`vmap(grad)` one call of each op; the JAX `mamba_forward` / `time_mix`
gradients at the families' 1e-5; an `optrace.OpTrace` of a training
layer records one op a pass with the loop form's flops, and a peak
that holds the backward's workspace.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import optrace
from repro_torch.models import mamba, recompute, rwkv6

GRAD_TOL = 1e-6


# ------------------------------------------------------- the loop forms


def scan_loop(x, dt, Bm, Cm, A, h):
    """The selective scan as the port ran it before the op."""
    f32 = torch.float32
    a = A[None] if A.dim() == 2 else A
    ys = []
    for i in range(x.shape[1]):
        x_t, dt_t = x[:, i].to(f32), dt[:, i]
        B_t, C_t = Bm[:, i].to(f32), Cm[:, i].to(f32)
        decay = torch.exp(dt_t[..., None] * a)
        h = decay * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_t))
    return torch.stack(ys, dim=1), h


def wkv_loop(r, k, v, logw, u, state):
    """The chunked WKV as the port ran it before the op."""
    b, nc, L, H, e = r.shape
    dev = r.device
    mask = (torch.arange(L, device=dev)[:, None]
            > torch.arange(L, device=dev)[None, :]).to(torch.float32)
    eye = torch.eye(L, dtype=torch.float32, device=dev)
    U = u[None, None] if u.dim() == 2 else u[:, None]
    S = state
    outs = []
    for c in range(nc):
        rc, kc, vc, lwc = r[:, c], k[:, c], v[:, c], logw[:, c]
        cw = torch.cumsum(lwc, dim=1)
        cwe = cw - lwc
        r_t = rc * torch.exp(cwe)
        k_t = kc * torch.exp(-cw)
        scores = torch.einsum("blhe,bmhe->bhlm", r_t, k_t) * mask[None, None]
        diag = torch.einsum("blhe,blhe->bhl", rc, U * kc)
        scores = scores + torch.einsum("bhl,lm->bhlm", diag, eye)
        o_intra = torch.einsum("bhlm,bmhe->blhe", scores, vc)
        o_inter = torch.einsum("blhe,bhef->blhf", r_t, S)
        cw_last = cw[:, -1]
        k_carry = kc * torch.exp(cw_last[:, None] - cw)
        S = S * torch.exp(cw_last)[..., None] + torch.einsum(
            "blhe,blhf->bhef", k_carry, vc)
        outs.append(o_intra + o_inter)
    return torch.stack(outs, dim=1).reshape(b, nc * L, H, e), S


# --------------------------------------------------------------- inputs

R, T, DI, N = 3, 13, 6, 4  # rows, steps (chunks of 4, the last of 1)
B_, NC, L, H, E = 2, 3, 8, 2, 4


def scan_inputs(seed=0, stream=torch.float32, per_row=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((R, T, DI), generator=g).to(stream)
    dt = torch.rand((R, T, DI), generator=g) * 0.5
    Bm = torch.randn((R, T, N), generator=g).to(stream)
    Cm = torch.randn((R, T, N), generator=g).to(stream)
    A = -torch.rand((R, DI, N) if per_row else (DI, N), generator=g) - 0.1
    h0 = torch.randn((R, DI, N), generator=g)
    return x, dt, Bm, Cm, A, h0


def wkv_inputs(seed=0, per_row=False):
    g = torch.Generator().manual_seed(seed)
    shape = (B_, NC, L, H, E)
    r, k, v = (torch.randn(shape, generator=g) for _ in range(3))
    # log-decays over the whole clamped range, down to -40 / L
    logw = -(torch.rand(shape, generator=g) * (40.0 / L - 1e-6) + 1e-6)
    u = torch.randn((B_, H, E) if per_row else (H, E), generator=g)
    S0 = torch.randn((B_, H, E, E), generator=g)
    return r, k, v, logw, u, S0


OPS = {"scan": (mamba.scan, scan_loop, scan_inputs, 4),
       "wkv": (rwkv6.wkv, wkv_loop, wkv_inputs, 4)}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _cotangents(outs, seed=7):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(o.shape, generator=g) for o in outs)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("op", ["scan", "wkv"])
def test_opcheck(op, per_row):
    fn = {"scan": (mamba.selective_scan, mamba.selective_scan_backward),
          "wkv": (rwkv6.wkv_chunked, rwkv6.wkv_chunked_backward)}[op]
    args = OPS[op][2](per_row=per_row)
    torch.library.opcheck(fn[0], args)
    torch.library.opcheck(fn[0], tuple(a.clone().requires_grad_()
                                       for a in args))
    outs = fn[0](*args)
    torch.library.opcheck(fn[1], _cotangents(outs) + args)


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
def test_scan_forward_is_the_loop_bit_for_bit(stream):
    args = scan_inputs(stream=stream)
    for got, want in zip(mamba.selective_scan(*args), scan_loop(*args)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_wkv_forward_is_the_loop_bit_for_bit():
    args = wkv_inputs()
    for got, want in zip(rwkv6.wkv_chunked(*args), wkv_loop(*args)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("op", ["scan", "scan_bf16", "wkv"])
def test_grads_equal_the_loop_forms(op, per_row):
    """Plain autograd: every input's gradient, in its dtype and shape."""
    base = op.split("_")[0]
    fn, loop, make, _ = OPS[base]
    kw = {"stream": torch.bfloat16} if op == "scan_bf16" else {}
    args = make(per_row=per_row, **kw)
    a1 = [a.clone().requires_grad_() for a in args]
    a2 = [a.clone().requires_grad_() for a in args]
    out1, out2 = fn(*a1), loop(*a2)
    cts = _cotangents(out2)
    g1 = torch.autograd.grad(out1, a1, cts)
    g2 = torch.autograd.grad(out2, a2, cts)
    for i, (got, want) in enumerate(zip(g1, g2)):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        assert _rel(got, want) <= GRAD_TOL, (op, i, _rel(got, want))


def _loss(fn):
    def loss(p, first, *rest):
        outs = fn(first, *rest[:3], p, rest[3])
        return torch.sum(outs[0] ** 2) + torch.sum(torch.sin(outs[1]))
    return loss


@pytest.mark.parametrize("own_param", [True, False])
@pytest.mark.parametrize("op", ["scan", "wkv"])
def test_vmap_grad_folds_the_clients_into_one_call(op, own_param):
    """vmap(grad) over K = 3 clients, each its own first input and its
    own shared parameter (A or u), or all one (the round's shared
    start): the gradients equal the loop form's, each client's own, and
    each op runs once a pass."""
    fn, loop, make, _ = OPS[op]
    args = make()
    k = 3
    p = (torch.stack([args[4] * (1 + 0.25 * i) for i in range(k)])
         if own_param else args[4])
    first = torch.stack([args[0].float() * (1 - 0.2 * i)
                         for i in range(k)]).to(args[0].dtype)
    rest = args[1:4] + args[5:]
    dims = (0 if own_param else None, 0) + (None,) * len(rest)

    def run(f):
        return torch.func.vmap(torch.func.grad(_loss(f), argnums=(0, 1)),
                               in_dims=dims)(p, first, *rest)

    with optrace.OpTrace() as trace:
        got = run(fn)
    want = run(loop)
    for g, w in zip(got, want):
        assert g.shape[0] == k and g.shape == w.shape
        assert _rel(g, w) <= GRAD_TOL
    calls = [o for o in trace.ops if "repro_torch" in o.name]
    assert [o.name.split(".")[1] for o in calls] == (
        ["selective_scan", "selective_scan_backward"] if op == "scan"
        else ["wkv_chunked", "wkv_chunked_backward"])
    assert calls[0].in_shapes[0][0] == k * args[0].shape[0]  # folded rows


@pytest.mark.parametrize("op", ["scan", "wkv"])
def test_grads_inside_the_recompute_rerun(op):
    """The op inside `recompute.recompute` under vmap(grad), as a
    training group runs it: the same gradients as without the rerun."""
    fn, _, make, _ = OPS[op]
    args = make()
    k = 2
    p = torch.stack([args[4], args[4] * 0.5])
    rest = args[:4] + args[5:]

    def loss_rerun(p, *rest):
        def body(p, *rest):
            return fn(*rest[:4], p, rest[4])
        outs = recompute.recompute(body, p, *rest)
        return torch.sum(outs[0] ** 2) + torch.sum(torch.sin(outs[1]))

    def loss_plain(p, *rest):
        outs = fn(*rest[:4], p, rest[4])
        return torch.sum(outs[0] ** 2) + torch.sum(torch.sin(outs[1]))

    dims = (0,) + (None,) * len(rest)
    argnums = (0, 2)
    got = torch.func.vmap(torch.func.grad(loss_rerun, argnums=argnums),
                          in_dims=dims)(p, *rest)
    want = torch.func.vmap(torch.func.grad(loss_plain, argnums=argnums),
                           in_dims=dims)(p, *rest)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape[0] == k


def test_mamba_grads_match_jax():
    """d(sum y^2)/d(x, params) of one Mamba block, the port's op against
    jax.grad of the reference's `mamba_forward` on the same inputs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.models import mamba as jmamba
    from repro_torch.configs import registry as treg

    jcfg, cfg = jreg.smoke("jamba-1.5-large-398b"), treg.smoke(
        "jamba-1.5-large-398b")
    jp = jmamba.mamba_init(jax.random.key(5), jcfg)
    x = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    wg = jax.grad(lambda p, x: jnp.sum(jmamba.mamba_forward(
        p, jcfg, x, None)[0] ** 2), argnums=(0, 1))(jp, jnp.asarray(x))
    p = {k: torch.from_numpy(np.asarray(v)).requires_grad_()
         for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = mamba.mamba_forward(p, cfg, xt, None)
    torch.sum(y ** 2).backward()
    for name, g in list(wg[0].items()) + [("x", wg[1])]:
        got = (xt if name == "x" else p[name]).grad.numpy()
        want = np.asarray(g)
        assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max()), (
            name, np.abs(got - want).max())


def test_rwkv_time_mix_grads_match_jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.models import rwkv6 as jrwkv
    from repro_torch.configs import registry as treg

    jcfg, cfg = jreg.smoke("rwkv6-3b"), treg.smoke("rwkv6-3b")
    jp = jrwkv.rwkv_init(jax.random.key(6), jcfg)
    x = np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    wg = jax.grad(lambda p, x: jnp.sum(jrwkv.time_mix(
        p, jcfg, x, None)[0] ** 2), argnums=(0, 1))(jp, jnp.asarray(x))
    p = {k: torch.from_numpy(np.asarray(v)).requires_grad_()
         for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = rwkv6.time_mix(p, cfg, xt, None)
    torch.sum(y ** 2).backward()
    for name, g in list(wg[0].items()) + [("x", wg[1])]:
        t = xt if name == "x" else p[name]
        if t.grad is None:  # the channel mix's leaves
            assert not np.any(np.asarray(g)), name
            continue
        want = np.asarray(g)
        assert np.abs(t.grad.numpy() - want).max() <= 1e-5 * (
            1 + np.abs(want).max()), name


def _trace_train(fn, args, backward=True):
    ins = [a.to("meta").requires_grad_() for a in args]
    with optrace.OpTrace() as trace:
        outs = fn(*ins)
        if backward:
            torch.autograd.grad(outs, ins, tuple(
                torch.empty(o.shape, device="meta") for o in outs))
    return trace


@pytest.mark.parametrize("op", ["scan", "wkv"])
def test_optrace_records_one_op_a_pass_with_the_loop_flops(op):
    fn, loop, make, _ = OPS[op]
    args = make()
    for backward in (False, True):
        got = _trace_train(fn, args, backward)
        want = _trace_train(loop, args, backward)
        ours = {n: c for n, c in got.histogram.items() if "repro_torch" in n}
        assert sorted(ours.values()) == [1] * (2 if backward else 1)
        assert got.flops == want.flops > 0
    # the backward's workspace is part of the trace's peak
    base = "selective_scan_backward" if op == "scan" else \
        "wkv_chunked_backward"
    outs = (mamba.selective_scan if op == "scan" else rwkv6.wkv_chunked)(
        *args)
    work = optrace.recurrent_workspace(base, _cotangents(outs) + args)
    assert work > 0 and got.peak >= work


@pytest.mark.parametrize("block", ["mamba", "rwkv"])
def test_optrace_of_a_training_layer_records_one_op_a_pass(block):
    """A whole layer on meta under grad: one forward op, one backward."""
    from repro_torch.configs import registry
    from repro_torch.models import layers

    cfg = registry.smoke("jamba-1.5-large-398b" if block == "mamba"
                         else "rwkv6-3b")
    init = mamba.mamba_init(cfg) if block == "mamba" else \
        rwkv6.rwkv_init(cfg)
    p = {k: v.requires_grad_() for k, v in layers.make(
        init, None, torch.device("meta")).items()}
    x = torch.empty((2, 32, cfg.d_model), device="meta", requires_grad=True)
    with optrace.OpTrace() as trace:
        y = (mamba.mamba_forward(p, cfg, x, None) if block == "mamba"
             else rwkv6.time_mix(p, cfg, x, None))[0]
        torch.autograd.grad(y, [x], torch.empty(y.shape, device="meta"))
    ours = sorted(n.split(".", 1)[1] for n in trace.histogram
                  if "repro_torch" in n)
    assert ours == (["selective_scan.default",
                     "selective_scan_backward.default"] if block == "mamba"
                    else ["wkv_chunked.default",
                          "wkv_chunked_backward.default"])
    assert all(trace.histogram[n] == 1 for n in trace.histogram
               if "repro_torch" in n)
