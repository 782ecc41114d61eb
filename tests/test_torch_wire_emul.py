"""What a lane of the wire aggregation kernels (`weighted_agg_q`,
`weighted_agg_q4` in `repro_torch/kernels/csrc/weighted_agg_q.cu`) does,
emulated in numpy, so that the kernels' arithmetic and index math are
tested without a GPU.

* The bit-built conversion (`wire.cuh`'s f23 / f19): a byte or nibble
  permuted into the low mantissa byte of a power of two, minus that power
  and the bias, is exactly float(b): all 256 bytes and all 16 nibbles
  (-8 included, which the wire never sends) at every position of a word.
* The realignment (`wire.cuh`'s realign16 and the kernel's `load_row` /
  `row_bytes`): lane l loads the aligned 16-byte word l of the warp's span
  of a row and takes the next word from lane l + 1; its 16 bytes equal a
  direct slice of the row for every row start mod 16, on both wires, at
  ragged ends and at rows shorter than one tile, and no lane loads a word
  that holds no byte of the row.
* The whole launch (grid, 31 tiles a warp, scale columns, the fold, the
  int4 rows split over two warps and their sums added in one fixed
  order, the stores) against the plain versions at the normalised 1e-5
  of tests/test_torch_kernels.py, every column written once, bytes
  around the rows filled with garbage.

The constants mirror the CUDA source: 4 warps a block, 31 tiles of 16
bytes a warp, each warp's sums in f32 by fused multiply-add over its
rows in order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import weighted_agg as twa
from repro_torch.transport.quantize import CHUNK, num_chunks, num_groups
from test_torch_kernels import assert_agg_close

WARPS, TILES = 4, 31  # kWarps (warps of a block), kTiles (tiles a warp)
U32 = np.uint32


# ---------------------------------------------------------- lane arithmetic


def byte_perm(x, y, s: int):
    """CUDA's __byte_perm: byte n of the result is byte s<4n+2:4n> of the
    eight bytes of (x, y), x's first."""
    x, y = np.asarray(x, U32), np.asarray(y, U32)
    src = [(x >> U32(8 * i)) & U32(0xFF) for i in range(4)] + \
          [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, U32)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 7] << U32(8 * n)
    return out


def f23(x, i: int) -> np.ndarray:
    return byte_perm(x, 0x4B000000, 0x7440 | i).view(np.float32)


def f19(x, i: int) -> np.ndarray:
    return byte_perm(x, 0x49000000, 0x7440 | i).view(np.float32)


K_S8_BIAS = np.float32(8388736.0)  # 2^23 + 128
K_LO_BIAS = np.float32(8388616.0)  # 2^23 + 8
K_HI_BIAS = np.float32(524296.0)  # 2^19 + 8


def decode_s8(word):
    """The 4 int8 values of each word, as the kernel builds them."""
    x = np.asarray(word, U32) ^ U32(0x80808080)
    return np.stack([f23(x, i) - K_S8_BIAS for i in range(4)], -1)


def decode_s4(word):
    """The 8 nibbles of each word in logical order (low nibble first)."""
    x = np.asarray(word, U32) ^ U32(0x88888888)
    lo, hi = x & U32(0x0F0F0F0F), x & U32(0xF0F0F0F0)
    out = []
    for i in range(4):
        out += [f23(lo, i) - K_LO_BIAS, f19(hi, i) - K_HI_BIAS]
    return np.stack(out, -1)


def funnelshift_r(lo, hi, sh: int):
    both = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return ((both >> np.uint64(sh)) & np.uint64(0xFFFFFFFF)).astype(U32)


def realign16(a, b, r: int):
    """wire.cuh's realign16 on (..., 4) uint32 words."""
    v = np.concatenate([a, b], -1)
    if r & 8:
        v = np.concatenate([v[..., 2:], v[..., 6:]], -1)
    if r & 4:
        v = np.concatenate([v[..., 1:], v[..., 7:]], -1)
    sh = (r & 3) * 8
    return np.stack([funnelshift_r(v[..., j], v[..., j + 1], sh)
                     for j in range(4)], -1)


def fma32(a, b, c):
    """f32 fused multiply-add, through f64 (exact products of these
    operands; the sum rounds once more)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


# ----------------------------------------------------------- the warp's view


def split_of(group_size) -> int:
    """kSplitOf: warps that share a tile's rows (int4 with a scale a lane:
    2, even and odd rows; else 1)."""
    return 2 if group_size is not None and group_size >= 32 else 1


def grid_tiles(nb: int, split: int = 1) -> np.ndarray:
    """(spans, 32): the tile index of every lane of each warp span of 31
    tiles that the launch covers (blocks_for: WARPS // split spans a
    block, so the last block may hold spans past the row's end)."""
    spans = -(-(-(-nb // 16)) // TILES)
    per_block = WARPS // split
    spans = -(-spans // per_block) * per_block
    return np.arange(spans)[:, None] * TILES + np.arange(32)[None]


def lane_bytes(buf: np.ndarray, p: int, nb: int, tile: np.ndarray,
               touched: np.ndarray):
    """Each lane's 16 row bytes as 4 uint32 words (load_row + row_bytes):
    the aligned word `tile` of the row's span where it holds a row byte,
    then the right neighbour's word by a shuffle down (lane 31 keeps its
    own). Marks the buffer bytes loaded in `touched`."""
    r = p % 16
    base = p - r
    words = np.zeros(tile.shape + (4,), U32)
    held = 16 * tile < nb + r
    at = base + 16 * tile[held]
    assert np.all((at % 16 == 0) & (at < p + nb) & (at + 16 > p))
    idx = at[:, None] + np.arange(16)[None]
    words[held] = np.ascontiguousarray(buf[idx]).view("<u4")
    touched[idx] = True
    if r == 0:
        return words
    nxt = np.concatenate([words[:, 1:], words[:, 31:]], 1)
    return realign16(words, nxt, r)


def place(values: np.ndarray, offset: int, rng):
    """The (K, nb) wire rows, row k at byte offset + k * nb of a buffer of
    random garbage that extends past both ends by a 16-byte word."""
    k, nb = values.shape
    buf = rng.integers(0, 256, size=offset + k * nb + 48).astype(np.uint8)
    buf[16 + offset: 16 + offset + k * nb] = values.reshape(-1).view(
        np.uint8)
    return buf, [16 + offset + i * nb for i in range(k)]


def emulate(w, values, scales, *, n, group_size=None, offset=0, seed=0):
    """The launch of agg_q8_kernel (group_size None) or agg_q4_kernel over
    values (K, nb) int8, lane by lane: warp part j of a tile sums the rows
    k = j mod split in order, the parts are added in order 0, 1, and the
    span's columns are stored. Returns y (n,) and how often each column
    was stored."""
    rng = np.random.default_rng(seed)
    k, nb = values.shape
    split = split_of(group_size)
    per = 16 if group_size is None else 32  # columns per tile
    buf, starts = place(values, offset, rng)
    touched = np.zeros(buf.shape, bool)
    tile = grid_tiles(nb, split)
    col = per * tile
    ncols = scales.shape[1]
    acc = np.zeros((split,) + tile.shape + (per,), np.float32)
    for kk in range(k):
        b = lane_bytes(buf, starts[kk], nb, tile, touched)
        if group_size is None:
            v = decode_s8(b).reshape(tile.shape + (16,))
            c = np.minimum(col >> 14, ncols - 1)  # CHUNK = 2^14
            s = (np.float32(w[kk]) * scales[kk, c])[..., None]
        else:
            v = decode_s4(b).reshape(tile.shape + (32,))
            lg = int(np.log2(group_size))
            if lg >= 5:  # WIDE: one scale per tile
                s = (np.float32(w[kk]) * scales[kk, np.minimum(
                    col >> lg, ncols - 1)])[..., None]
            else:  # one per byte, both nibbles
                e = col[..., None] + 2 * (np.arange(32) // 2)[None, None]
                s = np.float32(w[kk]) * scales[kk, np.minimum(e >> lg,
                                                            ncols - 1)]
        part = kk % split
        acc[part] = fma32(s.astype(np.float32), v, acc[part])
    total = acc[0]
    for j in range(1, split):  # store_tile's fixed order
        total = total + acc[j]
    # span i stores its first min(TILES * per, n - first) columns, from
    # lanes 0..30 in tile order (never lane 31)
    y = np.zeros(n, np.float32)
    stores = np.zeros(n, int)
    for span in range(tile.shape[0]):
        first = per * TILES * span
        m = min(TILES * per, n - first)
        if m > 0:
            y[first:first + m] = total[span, :TILES].reshape(-1)[:m]
            stores[first:first + m] += 1
    return y, stores


# --------------------------------------------------------------------- tests


def test_bit_built_int8_is_exact_for_every_byte():
    b = np.arange(-128, 128, dtype=np.int8)
    for i in range(4):  # byte i of a word
        word = (b.view(np.uint8).astype(U32) << U32(8 * i))
        got = decode_s8(word)[:, i]
        np.testing.assert_array_equal(got, b.astype(np.float32))
        assert got.dtype == np.float32


def test_bit_built_nibbles_are_exact_for_every_value():
    v = np.arange(-8, 8)  # -8 included, which the wire never sends
    raw = (v & 0xF).astype(U32)
    for pos in range(8):  # nibble pos of a word: byte pos // 2, low first
        got = decode_s4(raw << U32(4 * pos))[:, pos]
        np.testing.assert_array_equal(got, v.astype(np.float32))


@pytest.mark.parametrize("r", range(16))
def test_realign16_is_a_byte_slice(r):
    rng = np.random.default_rng(r)
    a, b = (rng.integers(0, 2**32, size=(50, 4), dtype=np.uint64).astype(U32)
            for _ in range(2))
    got = realign16(a, b, r).view(np.uint8).reshape(50, 16)
    both = np.concatenate([a, b], 1).view(np.uint8).reshape(50, 32)
    np.testing.assert_array_equal(got, both[:, r:r + 16])


@pytest.mark.parametrize("nb", [3, 5, 16, 17, 31 * 16, 31 * 16 + 9,
                                32 * 16 + 1, 1000])
@pytest.mark.parametrize("r", range(16))
def test_lane_bytes_are_the_row_for_every_start(nb, r):
    rng = np.random.default_rng(nb * 16 + r)
    row = rng.integers(-128, 128, size=(1, nb)).astype(np.int8)
    buf, (p,) = place(row, r, rng)
    assert p % 16 == r
    touched = np.zeros(buf.shape, bool)
    tile = grid_tiles(nb)
    got = lane_bytes(buf, p, nb, tile, touched).view(np.uint8)
    got = got.reshape(tile.shape + (16,))
    want = row[0].view(np.uint8)
    for wi, li in zip(*np.nonzero(np.arange(32)[None] < TILES)):
        t = int(tile[wi, li])
        m = max(0, min(16, nb - 16 * t))
        np.testing.assert_array_equal(got[wi, li, :m], want[16 * t:
                                                             16 * t + m])
    # every row byte was read, through words that each hold one
    assert touched[p:p + nb].all()
    assert not touched[:p - r].any() and not touched[-(-(p + nb) // 16)
                                                     * 16:].any()


@pytest.mark.parametrize("offset", [0, 2, 7, 15])
@pytest.mark.parametrize("k,n", [(1, 5), (3, 100), (4, 31 * 16 + 3),
                                 (10, CHUNK + 1), (5, 2 * CHUNK + 600)])
def test_emulated_int8_launch_matches_plain(k, n, offset):
    rng = np.random.default_rng(k * n + offset)
    values = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    scales = (10.0 ** rng.integers(-3, 3, size=(k, num_chunks(n)))
              * rng.uniform(0.5, 1.0, size=(k, num_chunks(n)))
              ).astype(np.float32)
    w = rng.uniform(size=k).astype(np.float32)
    y, stores = emulate(w, values, scales, n=n, offset=offset, seed=n)
    np.testing.assert_array_equal(stores, 1)
    want = twa.weighted_agg_q_plain(*(torch.from_numpy(a) for a in
                                      (w, values, scales)))
    x = values.astype(np.float32) * np.repeat(scales, CHUNK, 1)[:, :n]
    assert_agg_close(y, want.numpy(), w, x)


@pytest.mark.parametrize("gs", [2, 8, 16, 32, 512, CHUNK])
@pytest.mark.parametrize("k,n", [(1, 5), (3, 63), (4, 2 * 31 * 16 * 2 + 7),
                                 (5, 2 * CHUNK + 601)])
def test_emulated_int4_launch_matches_plain(k, n, gs):
    rng = np.random.default_rng(k * n + gs)
    nb = -(-n // 2)
    values = rng.integers(-128, 128, size=(k, nb)).astype(np.int8)
    g = num_groups(n, gs)
    scales = (10.0 ** rng.integers(-3, 3, size=(k, g))
              * rng.uniform(0.5, 1.0, size=(k, g))).astype(np.float32)
    w = rng.uniform(size=k).astype(np.float32)
    y, stores = emulate(w, values, scales, n=n, group_size=gs,
                        offset=(k * 5) % 16, seed=n)
    np.testing.assert_array_equal(stores, 1)
    want = twa.weighted_agg_q4_plain(
        *(torch.from_numpy(a) for a in (w, values, scales)), n=n,
        group_size=gs)
    nib = ((values.astype(np.int32)[..., None] >> np.array([0, 4])) & 0xF
           ^ 8) - 8
    x = nib.reshape(k, -1)[:, :n] * np.repeat(scales, gs, 1)[:, :n]
    assert_agg_close(y, want.numpy(), w, x)
