"""What the grad_dot_stats kernel (`gdot_kernel` and, above one block,
`stats_sum_kernel` in `repro_torch/kernels/csrc/grad_dot.cu`) does,
emulated in numpy lane by lane, so that its index math and summation
order are tested without a GPU.

Block b owns elements [2048 b, 2048 (b + 1)). Lane l of warp w of its 8
warps owns the aligned 16-byte words 32 S w + 32 s + l (step s < S; S = 2
for f32, 1 for bf16) of the block's span of a and of b, each loaded only
where it holds a byte of the input. An input that does not start on a
16-byte boundary is realigned with wire.cuh's realign16: each lane takes
its right neighbour's word by a shuffle, step s's lane 31 takes step s +
1's lane 0 word, and after the last step lane 31 loads the next warp's
first word itself. Elements past n are selected to zero; the lane sums
a b, a^2 and b^2 by FMA, steps and elements in order; each warp's sums
meet by xor shuffles, and the block adds its 8 warps' in order. One
block writes the result; more write statistic-major partials, which
stats_sum_kernel adds as tests/test_torch_stats_emul.py emulates it.

The emulated launches are held to `grad_dot_stats_plain` at the
normalised 1e-5 of tests/test_torch_ops.py, f32 and bf16, at every offset
of a and of b mod 16, on one block and on several, at more blocks than
the second launch has threads, and with the bytes around the inputs
filled with garbage (random, or 0xFF: NaN in either type).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grad_dot as tgd
from test_torch_ops import assert_sums_close
from test_torch_stats_emul import SUM_THREADS, stage2, warp_sum
from test_torch_wire_emul import U32, fma32, realign16

THREADS, WARPS, SPAN = 256, 8, 2048  # kThreads, kWarps, kSpan
F32 = np.float32
DTYPES = {"float32": (4, torch.float32), "bfloat16": (2, torch.bfloat16)}


def per_word(dtype: str) -> int:
    """kPer: elements of a 16-byte word."""
    return 16 // DTYPES[dtype][0]


def steps(dtype: str) -> int:
    """kSteps: words of an input a lane owns."""
    return SPAN // per_word(dtype) // THREADS


def place(data: np.ndarray, offset: int, rng, fill=None):
    """The input's bytes at byte offset (mod 16) of a buffer that extends
    past both ends by garbage: random bytes, or `fill` in every byte."""
    raw = data.view(np.uint8)
    size = offset + raw.size + 64
    buf = (rng.integers(0, 256, size=size) if fill is None
           else np.full(size, fill)).astype(np.uint8)
    buf[16 + offset:16 + offset + raw.size] = raw
    return buf, 16 + offset


def step_words(buf, start: int, n: int, dtype: str, touched):
    """(blocks, WARPS, S, 32, 4) uint32: the 16 input bytes of every
    lane's every step (load_words + step_bytes), before the select."""
    es = DTYPES[dtype][0]
    s_n = steps(dtype)
    blocks = -(-n // SPAN)
    r = start % 16
    blk = np.arange(blocks)[:, None, None, None]
    base = start - r + blk * SPAN * es  # aligned: SPAN * es is 16 k
    nbytes = (n - blk * SPAN) * es
    warp = np.arange(WARPS)[None, :, None, None]
    step = np.arange(s_n)[None, None, :, None]
    lane = np.arange(32)[None, None, None, :]

    def load(i):
        i = np.broadcast_to(i, np.broadcast(i, base).shape)
        held = 16 * i < nbytes + r
        out = np.zeros(i.shape + (4,), U32)
        at = np.broadcast_to(base, i.shape)[held] + 16 * i[held]
        assert np.all((at % 16 == 0) & (at < start + n * es)
                      & (at + 16 > start))
        idx = at[:, None] + np.arange(16)[None]
        out[held] = np.ascontiguousarray(buf[idx]).view("<u4")
        touched[idx] = True
        return out

    own = load(32 * s_n * warp + 32 * step + lane)
    if r == 0:
        return own
    extra = load(32 * s_n * (warp + 1) + 0 * lane)  # lane 31's, broadcast
    nxt = np.empty_like(own)
    nxt[..., :31, :] = own[..., 1:, :]
    nxt[:, :, :-1, 31] = own[:, :, 1:, 0]  # step s + 1's lane 0
    nxt[:, :, -1, 31] = extra[:, :, 0, 31]
    return realign16(own, nxt, r)


def widen(words, dtype: str):
    """(..., 4) uint32 -> (..., kPer) f32 elements in order."""
    if dtype == "float32":
        return words.view(F32)
    lo = (words << U32(16)).view(F32)
    hi = (words & U32(0xFFFF0000)).view(F32)
    return np.stack([lo, hi], -1).reshape(words.shape[:-1] + (8,))


def emulate(a_bits, b_bits, dtype: str, *, oa=0, ob=0, seed=0, fill=None):
    """The launch(es) of one grad_dot_stats call on a, b (n,) (raw bits,
    placed at byte offsets oa, ob mod 16): (<a,b>, ||a||^2, ||b||^2) as
    f32."""
    rng = np.random.default_rng(seed)
    n = a_bits.size
    p = per_word(dtype)
    s_n = steps(dtype)
    vals = []
    for bits, off in ((a_bits, oa), (b_bits, ob)):
        buf, start = place(bits, off, rng, fill)
        touched = np.zeros(buf.shape, bool)
        vals.append(widen(step_words(buf, start, n, dtype, touched), dtype))
        assert touched[start:start + bits.nbytes].all()
    av, bv = vals  # (blocks, WARPS, S, 32, P)
    blocks = av.shape[0]
    blk = np.arange(blocks)[:, None, None]
    warp = np.arange(WARPS)[None, :, None]
    lane = np.arange(32)[None, None, :]
    dot, sa, sb = (np.zeros((blocks, WARPS, 32), F32) for _ in range(3))
    for s in range(s_n):
        e0 = blk * SPAN + (32 * s_n * warp + 32 * s + lane) * p
        ne = np.clip(n - e0, 0, p)
        for i in range(p):
            x = np.where(i < ne, av[:, :, s, :, i], F32(0))
            y = np.where(i < ne, bv[:, :, s, :, i], F32(0))
            dot = fma32(x, y, dot)
            sa = fma32(x, x, sa)
            sb = fma32(y, y, sb)
    red = np.stack([warp_sum(v)[..., 0] for v in (dot, sa, sb)], -1)
    part = np.zeros((blocks, 3), F32)
    for w in range(WARPS):  # the block's warps in order, from 0.f
        part = part + red[:, w]
    return part[0] if blocks == 1 else stage2(part)


# --------------------------------------------------------------------- inputs


def inputs(n, dtype, seed):
    """Raw bits of a and b (n,) and their f32 values: normal values over a
    few orders of magnitude, rounded to the dtype by torch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3)
        t = torch.from_numpy(x.astype(F32)).to(DTYPES[dtype][1])
        bits = t.view(torch.int32 if dtype == "float32" else torch.int16)
        out += [bits.numpy().copy(), t]
    return out


def check(n, dtype, oa, ob, seed=0, fill=None):
    a_bits, a, b_bits, b = inputs(n, dtype, seed)
    got = emulate(a_bits, b_bits, dtype, oa=oa, ob=ob, seed=seed, fill=fill)
    ad, bd = a.double().numpy(), b.double().numpy()
    assert_sums_close(list(got), tgd.grad_dot_stats_plain(a, b),
                      [np.abs(ad * bd).sum(), (ad * ad).sum(),
                       (bd * bd).sum()])
    return got


def offsets(dtype: str):
    """Every byte offset mod 16 at which the dtype's elements can start."""
    return range(0, 16, DTYPES[dtype][0])


# --------------------------------------------------------------------- tests


@pytest.mark.parametrize("n", [1, 5, 2047, 2048, 2049, 5000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_step_words_are_the_input_for_every_offset(dtype, n):
    """Every lane's realigned words hold exactly its elements, at every
    offset, and every word loaded holds a byte of the input."""
    a_bits = inputs(n, dtype, seed=n)[0]
    p = per_word(dtype)
    for off in offsets(dtype):
        rng = np.random.default_rng(off)
        buf, start = place(a_bits, off, rng)
        touched = np.zeros(buf.shape, bool)
        words = step_words(buf, start, n, dtype, touched)
        # (blocks, WARPS, S, 32, 4) -> the element stream of each block
        flat = np.ascontiguousarray(words).view(a_bits.dtype).reshape(-1)
        assert flat.size == -(-n // SPAN) * SPAN == words.shape[0] * WARPS \
            * steps(dtype) * 32 * p
        np.testing.assert_array_equal(flat[:n], a_bits)
        assert touched[start:start + a_bits.nbytes].all()


@pytest.mark.parametrize("n", [700, 2048, 5000])
@pytest.mark.parametrize("dtype,oa,ob", [
    (dtype, oa, ob) for dtype in DTYPES for oa in offsets(dtype)
    for ob in offsets(dtype)])
def test_emulated_grad_dot_every_offset_pair(dtype, oa, ob, n):
    check(n, dtype, oa, ob, seed=oa * 16 + ob)


@pytest.mark.parametrize("n", [1, 3, 10, 32, 64, 512, 800, 5120, 51200])
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_grad_dot_at_the_cnn_leaf_sizes(dtype, n):
    """The paper's CNN's leaf sizes (and a few shorter ones): one block up
    to 2,048 elements, as an odd client's row offset (8 mod 16) gives
    them against an aligned g."""
    check(n, dtype, 8, 0, seed=n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_grad_dot_more_blocks_than_sum_threads(dtype):
    """Over 256 blocks: the second launch's threads each add several
    blocks' partials."""
    n = SPAN * (SUM_THREADS + 40) + 3
    check(n, dtype, 4, 12, seed=1)


@pytest.mark.parametrize("n", [7, 2049])
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_grad_dot_nan_garbage_is_masked(dtype, n):
    """All bytes around a and b 0xFF (NaN): the select zeroes every
    element past n before any product."""
    got = check(n, dtype, 4, 8, seed=n, fill=0xFF)
    assert np.isfinite(got).all()
