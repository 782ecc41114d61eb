"""What the wire statistics kernels (`round_stats_q`, `round_stats_q4` in
`repro_torch/kernels/csrc/round_stats_q.cu`) do, emulated in numpy lane by
lane, so that their arithmetic, index math and reduction order are tested
without a GPU.

A lane reads its 16 row bytes as the wire aggregations do
(tests/test_torch_wire_emul.py emulates that part: `lane_bytes`, the
bit-built f32 of `decode_s8` / `decode_s4`), zeroes the bytes past the
row's end (and the odd-N padding nibble) by a mask fixed for the lane,
and sums v * g and v^2 over its columns in order, scaled once a row where
one scale covers the lane (there, unmasked, sum v^2 is the exact integer
that dp4a takes; x = v * s per byte below group size 32). With a mask the
lane holds m^2 g and m^2. Each two rows' sums leave the warp by a
butterfly of xor shuffles; a block adds its warps' row sums in warp
order. The second launch (stats_sum_kernel) adds each statistic's block
partials: thread t of 256 adds blocks t, t + 256, .. in order, then each
warp's 32 sums by xor shuffles, then the 8 warps' sums in order.

The two emulated launches are held to `round_stats_q_plain` /
`round_stats_q4_plain` at the normalised 1e-5 of
tests/test_torch_kernels.py, masked and not, at every row offset mod 16,
at rows shorter than one tile, at ragged and odd N and at more blocks
than the second launch has threads, for int4 group sizes 2 / 8 / 32 /
512 / CHUNK, with bytes around the rows filled with garbage.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import round_stats as trs
from repro_torch.transport.quantize import CHUNK, num_chunks, num_groups
from test_torch_kernels import assert_stats_close
from test_torch_wire_emul import (
    TILES,
    U32,
    decode_s4,
    decode_s8,
    fma32,
    lane_bytes,
    place,
)

WARPS, ROWS = 2, 2  # kWarps (warps of a block), kRows (rows in flight)
SUM_THREADS = 256  # kSumThreads: stats_sum_kernel's block
F32 = np.float32


def grid_tiles(nb: int) -> np.ndarray:
    """(spans, 32): the tile index of every lane of each warp span of 31
    tiles that the launch covers (WARPS spans a block, so the last block
    may hold a span past the row's end)."""
    spans = -(-(-(-nb // 16)) // TILES)
    spans = -(-spans // WARPS) * WARPS
    return np.arange(spans)[:, None] * TILES + np.arange(32)[None]


def xor_lanes(a, off: int):
    """__shfl_xor_sync over the last axis (the warp's 32 lanes)."""
    return a[..., np.arange(32) ^ off]


def warp_sum(v):
    for off in (16, 8, 4, 2, 1):
        v = v + xor_lanes(v, off)
    return v


def butterfly(d0, q0, d1, q1):
    """The kernel's butterfly: lane l ends with row (l >> 4) & 1's d (bit
    3 clear) or q (bit 3 set)."""
    lane = np.arange(32)
    up, mid = (lane & 16) != 0, (lane & 8) != 0
    a = np.where(up, d1, d0) + xor_lanes(np.where(up, d0, d1), 16)
    b = np.where(up, q1, q0) + xor_lanes(np.where(up, q0, q1), 16)
    c = np.where(mid, b, a) + xor_lanes(np.where(mid, a, b), 8)
    for off in (4, 2, 1):
        c = c + xor_lanes(c, off)
    return c


def keep_mask(nv, int4: bool):
    """(..., 4) uint32 and-masks of the bytes that hold a lane's nv
    logical columns (int4: nibble by nibble)."""
    out = np.zeros(nv.shape + (4,), U32)
    for b in range(16):
        if int4:
            m = (np.where(2 * b < nv, 0x0F, 0)
                 | np.where(2 * b + 1 < nv, 0xF0, 0)).astype(U32)
        else:
            m = np.where(b < nv, 0xFF, 0).astype(U32)
        out[..., b // 4] |= m << U32(8 * (b % 4))
    return out


def lane_columns(vec, col, nv, per):
    """Each lane's `per` values of vec from column col, zeros from nv on."""
    idx = col[..., None] + np.arange(per)
    held = np.arange(per) < nv[..., None]
    return np.where(held, vec[np.minimum(idx, len(vec) - 1)], 0).astype(F32)


def emulate_stats(values, scales, g, mask=None, *, group_size=None,
                  offset=0, seed=0):
    """The launches of stats_q_kernel and stats_sum_kernel over values
    (K, nb) int8: returns (dots, sqs, sqg) as f32 arrays. group_size None:
    the int8 wire; else int4 with n = len(g)."""
    rng = np.random.default_rng(seed)
    k, nb = values.shape
    n = len(g)
    int4 = group_size is not None
    per = 32 if int4 else 16
    lg = int(np.log2(group_size)) if int4 else 14
    wide = not int4 or lg >= 5
    buf, starts = place(values, offset, rng)
    touched = np.zeros(buf.shape, bool)
    tile = grid_tiles(nb)
    col = per * tile
    lane = np.arange(32)[None]
    nv = np.where(lane == TILES, 0, np.clip(n - col, 0, per))
    ncols = scales.shape[1]
    sc_col = np.minimum(col >> lg, ncols - 1)

    gw = lane_columns(g.astype(F32), col, nv, per)
    if mask is not None:
        mw = lane_columns(mask.astype(F32), col, nv, per)
        gm = gw * mw
        sg = np.zeros(tile.shape, F32)
        for e in range(per):
            sg = fma32(gm[..., e], gm[..., e], sg)
        gw, mw = mw * gm, mw * mw
    else:
        sg = np.zeros(tile.shape, F32)
        for e in range(per):
            sg = fma32(gw[..., e], gw[..., e], sg)
    keep = keep_mask(nv, int4)

    spans = tile.shape[0]
    s_len = 2 * k + 1
    red = np.full((spans, s_len), np.nan, F32)  # each entry written once
    for k0 in range(0, k, ROWS):
        sums = []
        for kk in range(k0, min(k, k0 + ROWS)):
            b = lane_bytes(buf, starts[kk], nb, tile, touched) & keep
            v = (decode_s4(b) if int4 else decode_s8(b)).reshape(
                tile.shape + (per,))
            if not wide:  # a scale a byte, both nibbles
                e = col[..., None] + 2 * (np.arange(32) // 2)
                v = v * scales[kk, np.minimum(e >> lg, ncols - 1)]
            d = np.zeros(tile.shape, F32)
            q = np.zeros(tile.shape, F32)
            for e in range(per):
                x = v[..., e]
                d = fma32(x, gw[..., e], d)
                q = fma32(x * mw[..., e] if mask is not None else x, x, q)
            if wide and mask is None:  # dp4a: the exact integer sum
                q = (v.astype(np.int64) ** 2).sum(-1).astype(F32)
            if wide:
                s = scales[kk, sc_col]
                d, q = d * s, q * (s * s)
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


def stage2(block_part):
    """stats_sum_kernel over the (blocks, S) partials: per statistic,
    thread t adds blocks t, t + 256, .. in order, each warp's 32 sums meet
    by xor shuffles, and the 8 warps' sums are added in order."""
    blocks, s_len = block_part.shape
    acc = np.zeros((s_len, SUM_THREADS), F32)
    for b0 in range(0, blocks, SUM_THREADS):
        chunk = block_part[b0:b0 + SUM_THREADS].T
        acc[:, :chunk.shape[1]] = acc[:, :chunk.shape[1]] + chunk
    warps = warp_sum(acc.reshape(s_len, SUM_THREADS // 32, 32))[..., 0]
    out = np.zeros(s_len, F32)
    for w in range(SUM_THREADS // 32):
        out = out + warps[:, w]
    return out


# --------------------------------------------------------------------- inputs


def int8_wire(k, n, rng):
    values = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    c = num_chunks(n)
    scales = (10.0 ** rng.integers(-3, 3, size=(k, c))
              * rng.uniform(0.5, 1.0, size=(k, c))).astype(F32)
    x = values.astype(F32) * np.repeat(scales, CHUNK, 1)[:, :n]
    return values, scales, x


def int4_wire(k, n, gs, rng):
    nib = rng.integers(-7, 8, size=(k, 2 * (-(-n // 2))))
    nib[:, n:] = 0  # the padding nibble of odd n
    values = ((nib[:, 0::2] & 0xF) | ((nib[:, 1::2] & 0xF) << 4)).astype(
        np.uint8).view(np.int8)
    g_count = num_groups(n, gs)
    scales = (10.0 ** rng.integers(-3, 3, size=(k, g_count))
              * rng.uniform(0.5, 1.0, size=(k, g_count))).astype(F32)
    x = nib[:, :n].astype(F32) * np.repeat(scales, gs, 1)[:, :n]
    return values, scales, x


def g_and_mask(n, rng, binary=True):
    g = rng.standard_normal(n).astype(F32)
    if binary:
        mask = (rng.uniform(size=n) > 0.3).astype(F32)
    else:
        mask = rng.uniform(0.0, 2.0, size=n).astype(F32)
    return g, mask


def plain(values, scales, g, mask, group_size):
    args = [torch.from_numpy(a) for a in (values, scales, g)]
    m = None if mask is None else torch.from_numpy(mask)
    if group_size is None:
        return trs.round_stats_q_plain(*args, m)
    return trs.round_stats_q4_plain(*args, m, group_size=group_size)


def check(values, scales, x, g, mask, group_size=None, offset=0, seed=0):
    got = emulate_stats(values, scales, g, mask, group_size=group_size,
                        offset=offset, seed=seed)
    want = plain(values, scales, g, mask, group_size)
    assert_stats_close(got, [t.numpy() for t in want], x, g, mask)
    return got


# --------------------------------------------------------------------- tests


def test_keep_mask_zeroes_exactly_the_bytes_past_the_row():
    for int4 in (False, True):
        per = 32 if int4 else 16
        for nv in range(per + 1):
            words = keep_mask(np.array([nv]), int4)[0]
            nibs = ((words[:, None] >> (U32(4) * np.arange(8, dtype=U32)))
                    & U32(0xF)).reshape(-1)
            if int4:
                want = np.where(np.arange(32) < nv, 0xF, 0)
            else:
                want = np.repeat(np.where(np.arange(16) < nv, 0xF, 0), 2)
            np.testing.assert_array_equal(nibs, want)


def test_butterfly_is_each_rows_warp_sum():
    rng = np.random.default_rng(0)
    vals = rng.integers(-1000, 1000, size=(4, 32)).astype(F32)  # exact
    c = butterfly(*vals)
    for lane in range(32):
        row, stat = (lane >> 4) & 1, (lane >> 3) & 1
        assert c[lane] == vals[2 * row + stat].sum()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", range(16))
def test_emulated_int8_stats_every_row_offset(offset, masked):
    rng = np.random.default_rng(offset)
    k, n = 3, 31 * 16 * 4 + 7  # one block, a ragged last tile
    values, scales, x = int8_wire(k, n, rng)
    g, mask = g_and_mask(n, rng)
    check(values, scales, x, g, mask if masked else None, offset=offset,
          seed=offset)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,n", [(1, 13), (2, 13), (3, 100),
                                 (5, 2 * CHUNK + 600), (2, 70_001)])
def test_emulated_int8_stats_match_plain(k, n, masked):
    rng = np.random.default_rng(k * n)
    values, scales, x = int8_wire(k, n, rng)
    g, mask = g_and_mask(n, rng)
    check(values, scales, x, g, mask if masked else None,
          offset=(k * 7) % 16, seed=n)


@pytest.mark.parametrize("gs", [2, 8, 32, 512, CHUNK])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,n", [(1, 13), (3, 63), (4, 2 * 31 * 16 * 2 + 7),
                                 (5, 2 * CHUNK + 601), (3, 140_001)])
def test_emulated_int4_stats_match_plain(k, n, gs, masked):
    rng = np.random.default_rng(k * n + gs)
    values, scales, x = int4_wire(k, n, gs, rng)
    g, mask = g_and_mask(n, rng)
    check(values, scales, x, g, mask if masked else None, group_size=gs,
          offset=(k * 5) % 16, seed=n)


@pytest.mark.parametrize("gs", [8, 512])
@pytest.mark.parametrize("offset", range(16))
def test_emulated_int4_stats_every_row_offset(offset, gs):
    rng = np.random.default_rng(offset + gs)
    k, n = 4, 2 * 31 * 16 * 2 - 3  # odd n: the padding nibble
    values, scales, x = int4_wire(k, n, gs, rng)
    g, mask = g_and_mask(n, rng)
    check(values, scales, x, g, mask, group_size=gs, offset=offset,
          seed=offset)


@pytest.mark.parametrize("gs", [None, 8, 512])
def test_emulated_stats_any_mask_values(gs):
    """(x m)(g m) = x (m^2 g) and (x m)^2 = x^2 m^2 hold for any m, not
    only 0/1: a mask of other values agrees within the tolerance too."""
    rng = np.random.default_rng(5)
    k, n = 3, 5_001
    values, scales, x = int8_wire(k, n, rng) if gs is None else \
        int4_wire(k, n, gs, rng)
    g, mask = g_and_mask(n, rng, binary=False)
    check(values, scales, x, g, mask, group_size=gs, offset=3)


def test_emulated_int4_padding_nibble_is_ignored():
    rng = np.random.default_rng(7)
    k, n, gs = 3, 2 * CHUNK + 1, 512
    values, scales, x = int4_wire(k, n, gs, rng)
    g, _ = g_and_mask(n, rng)
    clean = check(values, scales, x, g, None, group_size=gs, offset=9)
    dirty = values.copy()
    dirty[:, -1] |= np.int8(0x70)  # padding := 7
    got = emulate_stats(dirty, scales, g, group_size=gs, offset=9)
    for a, b in zip(clean, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gs", [None, 512])
def test_emulated_stats_more_blocks_than_sum_threads(gs, masked):
    """Over 256 blocks: the second launch's threads each add several
    blocks' partials."""
    rng = np.random.default_rng(13)
    k, n = 2, 1_100_001
    values, scales, x = int8_wire(k, n, rng) if gs is None else \
        int4_wire(k, n, gs, rng)
    assert grid_tiles(values.shape[1]).shape[0] // WARPS > SUM_THREADS
    g, mask = g_and_mask(n, rng)
    check(values, scales, x, g, mask if masked else None, group_size=gs,
          offset=6)
