"""What the bf16 statistics kernel (`round_stats` on bf16 x:
`stats_bf16_kernel` and `stats_sum_kernel` in
`repro_torch/kernels/csrc/round_stats.cu`) does, emulated in numpy lane by
lane, so that its index math and summation order are tested without a
GPU.

Lane l of a warp owns the 32-byte tile l of the warp's span of every row
(16 bf16 columns): the aligned 16-byte words 2t and 2t + 1 of the row's
span, each loaded only where it holds a byte of the row, and its right
neighbour's first word by a shuffle down (lane 31 only lends), realigned
by `wire.cuh`'s realign16 when the row starts r = 2, 4, .. 14 bytes into
a word (`load_row2`, `row_bytes2`). A mask fixed for the lane zeroes the
16-bit halves past its nv columns; bf16 widens to f32 by a 16-bit shift,
and the lane sums v g and v^2 (masked: (v m^2) v against m^2 g) by FMA in
column order. Two rows of a warp leave it by the butterfly of
tests/test_torch_stats_emul.py, the block adds its two warps in order,
and stats_sum_kernel adds the statistic-major block partials as that file
emulates it.

The emulated launches are held to `round_stats_plain` at the normalised
1e-5 of tests/test_torch_kernels.py: at every even row offset mod 16,
masked and not, at rows shorter than one tile, at ragged and odd N, with
the bytes around the rows filled with garbage (random, or all 0xFF: NaN
in bf16), and at more blocks than the second launch has threads.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import round_stats as trs
from test_torch_kernels import assert_stats_close
from test_torch_stats_emul import (
    SUM_THREADS,
    butterfly,
    lane_columns,
    stage2,
    warp_sum,
)
from test_torch_wire_emul import U32, fma32, realign16

WARPS, TILES, ROWS = 2, 31, 2  # bf16::kWarps, kTiles, kRows
COLS = 16  # bf16::kCols: columns of a lane's 32-byte tile
F32 = np.float32


def grid_tiles(n: int) -> np.ndarray:
    """(spans, 32): the tile index of every lane of each warp span of 31
    tiles that the launch covers (blocks_for: WARPS spans a block)."""
    spans = -(-(-(-n // COLS)) // TILES)
    spans = -(-spans // WARPS) * WARPS
    return np.arange(spans)[:, None] * TILES + np.arange(32)[None]


def place(rows: np.ndarray, offset: int, rng, fill=None):
    """The (K, n) bf16 rows (uint16 bits), row k at byte offset + 2 k n of
    a buffer that extends past both ends by garbage: random bytes, or
    `fill` in every byte."""
    k, n = rows.shape
    size = offset + 2 * k * n + 64
    buf = (rng.integers(0, 256, size=size) if fill is None
           else np.full(size, fill)).astype(np.uint8)
    buf[16 + offset: 16 + offset + 2 * k * n] = rows.reshape(-1).view(
        np.uint8)
    return buf, [16 + offset + 2 * i * n for i in range(k)]


def lane_words(buf, p: int, nb: int, tile: np.ndarray, touched):
    """Each lane's 32 row bytes as two (..., 4) uint32 words (load_row2
    + row_bytes2). Marks the buffer bytes loaded in `touched`."""
    r = p % 16
    base = p - r

    def load(w):  # aligned word w of the row's span, where it holds a byte
        out = np.zeros(tile.shape + (4,), U32)
        held = 16 * w < nb + r
        at = base + 16 * w[held]
        assert np.all((at % 16 == 0) & (at < p + nb) & (at + 16 > p))
        idx = at[:, None] + np.arange(16)[None]
        out[held] = np.ascontiguousarray(buf[idx]).view("<u4")
        touched[idx] = True
        return out

    lo, hi = load(2 * tile), load(2 * tile + 1)
    if r == 0:
        return lo, hi
    nxt = np.concatenate([lo[:, 1:], lo[:, 31:]], 1)  # lane 31 keeps its own
    return realign16(lo, hi, r), realign16(hi, nxt, r)


def keep_mask(nv):
    """(..., 8) uint32 and-masks of the 16-bit halves that hold a lane's
    nv columns."""
    j = np.arange(8)
    return (np.where(2 * j < nv[..., None], 0x0000FFFF, 0)
            | np.where(2 * j + 1 < nv[..., None], 0xFFFF0000, 0)).astype(U32)


def widen(words):
    """(..., 8) uint32 words -> (..., 16) f32 columns, low half first."""
    lo = (words << U32(16)).view(F32)
    hi = (words & U32(0xFFFF0000)).view(F32)
    return np.stack([lo, hi], -1).reshape(words.shape[:-1] + (16,))


def emulate_stats(rows, g, mask=None, *, offset=0, seed=0, fill=None):
    """The launches of stats_bf16_kernel and stats_sum_kernel over bf16
    rows (K, n) (uint16 bits): (dots, sqs, sqg) as f32 arrays."""
    rng = np.random.default_rng(seed)
    k, n = rows.shape
    buf, starts = place(rows, offset, rng, fill)
    touched = np.zeros(buf.shape, bool)
    tile = grid_tiles(n)
    col = COLS * tile
    lane = np.arange(32)[None]
    nv = np.where(lane == TILES, 0, np.clip(n - col, 0, COLS))

    gw = lane_columns(g.astype(F32), col, nv, COLS)
    sg = np.zeros(tile.shape, F32)
    if mask is not None:
        mw = lane_columns(mask.astype(F32), col, nv, COLS)
        gm = gw * mw
        for e in range(COLS):
            sg = fma32(gm[..., e], gm[..., e], sg)
        gw, mw = mw * gm, mw * mw
    else:
        for e in range(COLS):
            sg = fma32(gw[..., e], gw[..., e], sg)
    keep = keep_mask(nv)

    spans = tile.shape[0]
    s_len = 2 * k + 1
    red = np.full((spans, s_len), np.nan, F32)  # each entry written once
    for k0 in range(0, k, ROWS):
        sums = []
        for kk in range(k0, min(k, k0 + ROWS)):
            lo, hi = lane_words(buf, starts[kk], 2 * n, tile, touched)
            v = widen(np.concatenate([lo, hi], -1) & keep)
            d = np.zeros(tile.shape, F32)
            q = np.zeros(tile.shape, F32)
            for e in range(COLS):  # column order, d then q
                x = v[..., e]
                d = fma32(x, gw[..., e], d)
                q = fma32(x * mw[..., e] if mask is not None else x, x, q)
            sums.append((kk, d, q))
        while len(sums) < ROWS:
            zero = np.zeros(tile.shape, F32)
            sums.append((k, zero, zero))
        c = butterfly(sums[0][1], sums[0][2], sums[1][1], sums[1][2])
        for u, (kk, _, _) in enumerate(sums):
            if kk < k:
                red[:, kk] = c[:, 16 * u]
                red[:, k + kk] = c[:, 16 * u + 8]
    red[:, 2 * k] = warp_sum(sg)[:, 0]
    assert not np.isnan(red).any()

    warps = red.reshape(spans // WARPS, WARPS, s_len)
    block_part = warps[:, 0]
    for w in range(1, WARPS):
        block_part = block_part + warps[:, w]
    out = stage2(block_part)
    return out[:k], out[k:2 * k], out[2 * k]


# --------------------------------------------------------------------- inputs


def bf16_rows(k, n, rng):
    """(uint16 bits (K, n), their f32 values): normal values over a few
    orders of magnitude, rounded to bf16 by torch."""
    x = rng.standard_normal((k, n)) * 10.0 ** rng.integers(-2, 3, (k, 1))
    t = torch.from_numpy(x.astype(F32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16), t.float().numpy()


def g_and_mask(n, rng, binary=True):
    g = rng.standard_normal(n).astype(F32)
    mask = ((rng.uniform(size=n) > 0.3) if binary
            else rng.uniform(0.0, 2.0, size=n)).astype(F32)
    return g, mask


def check(k, n, masked, offset, seed, fill=None, binary=True):
    rng = np.random.default_rng(seed)
    bits, x = bf16_rows(k, n, rng)
    g, mask = g_and_mask(n, rng, binary)
    m = mask if masked else None
    got = emulate_stats(bits, g, m, offset=offset, seed=seed, fill=fill)
    xt = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    want = trs.round_stats_plain(xt, torch.from_numpy(g),
                                 None if m is None else torch.from_numpy(m))
    assert_stats_close(got, [t.numpy() for t in want], x, g, m)
    return got


# --------------------------------------------------------------------- tests


@pytest.mark.parametrize("n", [1, 5, 16, 17, 31 * 16, 31 * 16 + 9, 1000])
@pytest.mark.parametrize("offset", range(0, 16, 2))
def test_lane_words_are_the_row_for_every_even_start(offset, n):
    rng = np.random.default_rng(n * 16 + offset)
    bits, _ = bf16_rows(1, n, rng)
    buf, (p,) = place(bits, offset, rng)
    assert p % 16 == offset
    touched = np.zeros(buf.shape, bool)
    tile = grid_tiles(n)
    got = np.concatenate(lane_words(buf, p, 2 * n, tile, touched), -1)
    got = got.view(np.uint16).reshape(tile.shape + (COLS,))
    for wi, li in zip(*np.nonzero(np.arange(32)[None] < TILES)):
        t = int(tile[wi, li])
        m = max(0, min(COLS, n - COLS * t))
        np.testing.assert_array_equal(got[wi, li, :m],
                                      bits[0, COLS * t:COLS * t + m])
    # every row byte was read, through words that each hold one
    assert touched[p:p + 2 * n].all()
    assert not touched[:p - offset].any()
    assert not touched[-(-(p + 2 * n) // 16) * 16:].any()


def test_keep_mask_keeps_exactly_the_lanes_columns():
    for nv in range(COLS + 1):
        halves = keep_mask(np.array([nv]))[0].view(np.uint16)
        np.testing.assert_array_equal(
            halves, np.where(np.arange(COLS) < nv, 0xFFFF, 0))


def test_widening_is_exact_for_every_bf16_pattern():
    bits = np.arange(1 << 16, dtype=U32)
    words = (bits[:, None] << U32(16)) | bits[:, None]  # both halves
    got = widen(np.repeat(words, 8, 1))
    want = torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16).float().numpy()
    for e in range(COLS):
        np.testing.assert_array_equal(got[:, e].view(U32), want.view(U32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", range(0, 16, 2))
def test_emulated_bf16_stats_every_row_offset(offset, masked):
    k, n = 3, 31 * COLS * 2 + 7  # one block, a ragged last tile
    check(k, n, masked, offset, seed=offset)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,n", [(1, 1), (2, 13), (3, 16), (3, 100),
                                 (4, 31 * COLS + 1), (5, 9_999),
                                 (2, 70_001)])
def test_emulated_bf16_stats_match_plain(k, n, masked):
    check(k, n, masked, offset=(2 * k + 6) % 16, seed=k * n)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", [0, 6, 14])
def test_emulated_bf16_stats_nan_garbage_is_masked(offset, masked):
    """All bytes around the rows 0xFF (NaN in bf16): the keep mask zeroes
    them before any product, so every sum stays finite and right."""
    got = check(3, 31 * COLS + 5, masked, offset, seed=offset, fill=0xFF)
    assert all(np.isfinite(t).all() for t in got)


def test_emulated_bf16_stats_any_mask_values():
    """(x m)(g m) = x (m^2 g) and (x m)^2 = x^2 m^2 hold for any m, not
    only 0/1: a mask of other values agrees within the tolerance too."""
    check(3, 5_001, True, offset=4, seed=5, binary=False)


@pytest.mark.parametrize("masked", [False, True])
def test_emulated_bf16_stats_more_blocks_than_sum_threads(masked):
    """Over 256 blocks: the second launch's threads each add several
    blocks' partials."""
    k, n = 3, 280_001
    assert grid_tiles(n).shape[0] // WARPS > SUM_THREADS
    check(k, n, masked, offset=8, seed=13)
