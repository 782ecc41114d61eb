"""What the f32 statistics kernel (`round_stats` on f32 x:
`stats_f32_kernel` and `stats_sum_kernel` in
`repro_torch/kernels/csrc/round_stats.cu`) does, emulated in numpy lane by
lane, so that its index math and summation order are tested without a
GPU.

Lane l of a warp owns the 32-byte tile l of the warp's span of every row
(8 f32 columns, where the bf16 kernel has 16 bf16 columns): the aligned
16-byte words 2t and 2t + 1 of the row's span, each loaded only where it
holds a byte of the row, and its right neighbour's first word by a
shuffle down (lane 31 only lends), realigned by `wire.cuh`'s realign16
when the row starts r = 4, 8 or 12 bytes into a word (`load_row2`,
`row_bytes2`). A select fixed for the lane drops the columns past its
nv; the lane sums v g and v^2 (masked: (v m^2) v against m^2 g) by FMA
in column order. Two rows of a warp leave it by the butterfly of
tests/test_torch_stats_emul.py, the block adds its two warps in order,
and stats_sum_kernel adds the statistic-major block partials as that
file emulates it.

The emulated launches are held to `round_stats_plain` at the normalised
1e-5 of tests/test_torch_kernels.py: at every row offset 0 / 4 / 8 / 12
mod 16, masked and not, at K = 1, 2, 3 and 37, at rows shorter than one
tile, at ragged and odd N up to 1,000,003, with the bytes around the rows
filled with garbage (random, or all 0xFF: NaN in f32), and at more blocks
than the second launch has threads.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import round_stats as trs
from test_torch_bf16_stats_emul import g_and_mask
from test_torch_kernels import assert_stats_close
from test_torch_stats_emul import (
    SUM_THREADS,
    butterfly,
    lane_columns,
    stage2,
    warp_sum,
)
from test_torch_wire_emul import U32, fma32, realign16

WARPS, TILES, ROWS = 2, 31, 2  # kWarps, kTiles, kRows
COLS = 8  # kColsOf<float>: f32 columns of a lane's 32-byte tile
WORDS = 2  # 16-byte words of a tile
F32 = np.float32


def grid_tiles(n: int) -> np.ndarray:
    """(spans, 32): the tile index of every lane of each warp span of 31
    tiles that the launch covers (blocks_for: WARPS spans a block)."""
    spans = -(-(-(-n // COLS)) // TILES)
    spans = -(-spans // WARPS) * WARPS
    return np.arange(spans)[:, None] * TILES + np.arange(32)[None]


def place(rows: np.ndarray, offset: int, rng, fill=None):
    """The (K, n) f32 rows, row k at byte offset + 4 k n of a buffer that
    extends past both ends by garbage: random bytes, or `fill` in every
    byte."""
    k, n = rows.shape
    size = offset + 4 * k * n + 128
    buf = (rng.integers(0, 256, size=size) if fill is None
           else np.full(size, fill)).astype(np.uint8)
    buf[16 + offset: 16 + offset + 4 * k * n] = rows.reshape(-1).view(
        np.uint8)
    return buf, [16 + offset + 4 * i * n for i in range(k)]


def lane_words(buf, p: int, nb: int, tile: np.ndarray, touched):
    """Each lane's 32 row bytes as WORDS (..., 4) uint32 words (load_row2
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

    words = [load(WORDS * tile + j) for j in range(WORDS)]
    if r == 0:
        return words
    # the right neighbour's first word; lane 31 keeps its own
    nxt = np.concatenate([words[0][:, 1:], words[0][:, 31:]], 1)
    return [realign16(words[j], words[j + 1] if j + 1 < WORDS else nxt, r)
            for j in range(WORDS)]


def emulate_stats(rows, g, mask=None, *, offset=0, seed=0, fill=None):
    """The launches of stats_f32_kernel and stats_sum_kernel over f32
    rows (K, n): (dots, sqs, sqg) as f32 arrays."""
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
    keep = np.arange(COLS) < nv[..., None]

    spans = tile.shape[0]
    s_len = 2 * k + 1
    red = np.full((spans, s_len), np.nan, F32)  # each entry written once
    for k0 in range(0, k, ROWS):
        sums = []
        for kk in range(k0, min(k, k0 + ROWS)):
            words = lane_words(buf, starts[kk], 4 * n, tile, touched)
            v = np.concatenate(words, -1).view(F32)
            v = np.where(keep, v, F32(0))  # a select: NaN garbage drops
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
    # every row byte was read, and no word that holds none
    for p in starts:
        assert touched[p:p + 4 * n].all()
    first, last = starts[0] - starts[0] % 16, -(-(starts[-1] + 4 * n) // 16)
    assert not touched[:first].any() and not touched[16 * last:].any()

    warps = red.reshape(spans // WARPS, WARPS, s_len)
    block_part = warps[:, 0]
    for w in range(1, WARPS):
        block_part = block_part + warps[:, w]
    out = stage2(block_part)
    return out[:k], out[k:2 * k], out[2 * k]


# --------------------------------------------------------------------- inputs


def f32_rows(k, n, rng):
    """Normal values over a few orders of magnitude, one scale a row."""
    return (rng.standard_normal((k, n))
            * 10.0 ** rng.integers(-2, 3, (k, 1))).astype(F32)


def check(k, n, masked, offset, seed, fill=None, binary=True):
    rng = np.random.default_rng(seed)
    x = f32_rows(k, n, rng)
    g, mask = g_and_mask(n, rng, binary)
    m = mask if masked else None
    got = emulate_stats(x, g, m, offset=offset, seed=seed, fill=fill)
    want = trs.round_stats_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 None if m is None else torch.from_numpy(m))
    assert_stats_close(got, [t.numpy() for t in want], x, g, m)
    return got


# --------------------------------------------------------------------- tests


@pytest.mark.parametrize("n", [1, 5, 8, 9, 31 * 8, 31 * 8 + 5, 1000])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_lane_words_are_the_row_for_every_start(offset, n):
    rng = np.random.default_rng(n * 16 + offset)
    x = f32_rows(1, n, rng)
    buf, (p,) = place(x, offset, rng)
    assert p % 16 == offset
    touched = np.zeros(buf.shape, bool)
    tile = grid_tiles(n)
    got = np.concatenate(lane_words(buf, p, 4 * n, tile, touched), -1)
    got = got.view(F32)
    for wi, li in zip(*np.nonzero(np.arange(32)[None] < TILES)):
        t = int(tile[wi, li])
        m = max(0, min(COLS, n - COLS * t))
        np.testing.assert_array_equal(got[wi, li, :m],
                                      x[0, COLS * t:COLS * t + m])
    # every row byte was read, through words that each hold one
    assert touched[p:p + 4 * n].all()
    assert not touched[:p - offset].any()
    assert not touched[-(-(p + 4 * n) // 16) * 16:].any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_emulated_f32_stats_every_row_offset(offset, masked):
    k, n = 3, 31 * COLS * 2 + 7  # one block, a ragged last tile
    check(k, n, masked, offset, seed=offset)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 13, 7_850, 16_385])
@pytest.mark.parametrize("k", [1, 2, 3, 37])
def test_emulated_f32_stats_match_plain(k, n, masked):
    check(k, n, masked, offset=(4 * k + 8) % 16, seed=k * n)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_emulated_f32_stats_at_a_million_odd_columns(k, masked):
    """N = 1,000,003: odd, so consecutive rows start 12 bytes apart mod
    16 and walk through every offset."""
    check(k, 1_000_003, masked, offset=4, seed=k)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", [0, 4, 12])
def test_emulated_f32_stats_nan_garbage_is_dropped(offset, masked):
    """All bytes around the rows 0xFF (NaN in f32): the select drops them
    before any product, so every sum stays finite and right."""
    got = check(3, 31 * COLS + 5, masked, offset, seed=offset, fill=0xFF)
    assert all(np.isfinite(t).all() for t in got)


def test_emulated_f32_stats_any_mask_values():
    """(x m)(g m) = x (m^2 g) and (x m)^2 = x^2 m^2 hold for any m, not
    only 0/1: a mask of other values agrees within the tolerance too."""
    check(3, 5_001, True, offset=8, seed=5, binary=False)


@pytest.mark.parametrize("masked", [False, True])
def test_emulated_f32_stats_more_blocks_than_sum_threads(masked):
    """Over 256 blocks: the second launch's threads each add several
    blocks' partials."""
    k, n = 3, 280_001
    assert grid_tiles(n).shape[0] // WARPS > SUM_THREADS
    check(k, n, masked, offset=8, seed=13)
