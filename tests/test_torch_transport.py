"""The port's uplink wire (repro_torch.transport) and its four wire
kernels against the JAX package, and (on a card) the CUDA kernels
against their plain versions.

* Quantizer: the port's `quantize` equals the reference's BIT FOR BIT
  (values and scales) for bf16 / int8 / int4, at N across the 16384-wide
  scale chunk (100, 16385, 2*16384+600) and int4 group sizes 32, 512 and
  16384, on data whose magnitude changes by orders of magnitude from one
  block to the next; with exact .5 ties (half to even), all-zero chunks
  and groups (scale 1) and odd N. `dequantize`, `pack_int4` /
  `unpack_int4`, `wire_bytes`, `round_bytes` and `validate_group_size`
  too.
* Kernels: on the CPU the wrappers take their plain versions, held to the
  reference's Pallas kernels (interpret mode, as tests/test_transport.py
  runs them) on the same wire, at K in {1, 33, 64} (across the
  reference's 32-client chunk) x the same N x group sizes. Tolerances:
  the port's normalised 1e-5 measure on the dequantized x
  (tests/test_torch_kernels.py) everywhere and, for the statistics, the
  reference's own too (rtol 1e-3 / atol 1e-2 for int8, rtol 2e-3 for
  int4). The reference's rtol for the aggregates is not applied: on this
  data an int4 sum over 64 clients can cancel to about 1 from terms of
  10^4, where two f32 summation orders differ by 1e-2 (1e-7 of the
  terms). Masks whose edges are odd offsets across a group and a chunk
  boundary, and the odd-N padding nibble.
* bf16: the bf16 wire through the plain f32 wrappers (f32 sums).

The JAX package's quantizer is reached as a module through importlib:
`repro.transport.quantize` names the function, which the package
re-exports. The `cuda`-marked class imports no jax and runs on a GPU
machine: `PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_transport.py`.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import transport as tq
from repro_torch.kernels import round_stats as trs
from repro_torch.kernels import weighted_agg as twa
from test_torch_kernels import assert_agg_close, assert_stats_close

CHUNK = 128 * 128
CHUNK_KS = [1, 33, 64]
NS = [100, CHUNK + 1, 2 * CHUNK + 600]
GROUP_SIZES = [32, 512, CHUNK]


def _jq():
    return importlib.import_module("repro.transport.quantize")


def _chunky(k, n, block=CHUNK, seed=0):
    """(k, n) normal data whose per-block magnitude changes by orders of
    magnitude, so a kernel reading the wrong scale column fails loudly."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, n)).astype(np.float32)
    return x * (10.0 ** (np.arange(n) // block % 5)).astype(np.float32)[None]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


def _jax_wire(x, transport, gs=tq.GROUP_SIZE):
    import jax.numpy as jnp

    q = _jq().quantize(jnp.asarray(x), transport, group_size=gs)
    return q, np.asarray(q.values)


def assert_same_wire(x, transport, gs=tq.GROUP_SIZE):
    """The port's wire of x is the reference's, bit for bit."""
    jwire, jvalues = _jax_wire(x, transport, gs)
    twire = tq.quantize(torch.from_numpy(x), transport, group_size=gs)
    assert twire.transport == transport
    np.testing.assert_array_equal(_torch_bits(twire.values), _bits(jvalues))
    if jwire.scales is None:
        assert twire.scales is None
    else:
        assert twire.scales.dtype == torch.float32
        np.testing.assert_array_equal(_torch_bits(twire.scales),
                                      _bits(jwire.scales))
    if transport == "int4":
        assert (twire.n, twire.group_size) == (jwire.n, jwire.group_size)
    np.testing.assert_array_equal(
        _bits(tq.dequantize(twire).numpy()),
        _bits(_jq().dequantize(jwire)))
    return twire


# ---------------------------------------------------------------- quantize


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("transport", ["bf16", "int8"])
def test_quantize_bit_for_bit(transport, n):
    x = _chunky(5, n, seed=n)
    x[2] = 0.0  # an all-zero row: every chunk scale 1
    assert_same_wire(x, transport)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_quantize_int4_bit_for_bit(n, gs):
    x = _chunky(5, n, block=gs, seed=n + gs)
    x[1, gs:2 * gs] = 0.0  # an all-zero group (where n allows one)
    q = assert_same_wire(x, "int4", gs)
    assert q.values.shape == (5, -(-n // 2))
    assert q.scales.shape == (5, tq.num_groups(n, gs))


def test_quantize_rounds_ties_half_to_even():
    """Scale 1 (absmax 127 or 7) makes every x / s an exact .5 tie."""
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 6.5],
                    np.float32)
    x8 = np.zeros((2, CHUNK + 11), np.float32)
    x8[0, :8], x8[0, 8] = ties, 127.0
    q8 = assert_same_wire(x8, "int8")
    assert q8.values[0, :9].tolist() == [0, 2, 2, 0, -2, -2, 4, 6, 127]
    assert q8.scales.tolist() == [[1.0, 1.0], [1.0, 1.0]]
    x4 = np.zeros((2, 33), np.float32)  # odd N
    x4[0, :8], x4[0, 8] = ties, 7.0
    q4 = assert_same_wire(x4, "int4", 32)
    nib = tq.unpack_int4(q4.values)
    assert nib[0, :9].tolist() == [0, 2, 2, 0, -2, -2, 4, 6, 7]
    assert q4.scales[:, 0].tolist() == [1.0, 1.0]


def test_zero_chunks_and_groups_reconstruct_exactly():
    x = np.zeros((2, CHUNK + 7), np.float32)
    x[1, CHUNK + 3] = 3.0
    for transport, gs in (("int8", 512), ("int4", 32)):
        q = assert_same_wire(x, transport, gs)
        back = tq.dequantize(q).numpy()
        np.testing.assert_array_equal(back[0], 0.0)
        assert back[1, CHUNK + 3] == 3.0
        assert float(q.scales[0, 0]) == 1.0


def test_pack_unpack_match_the_reference():
    import jax.numpy as jnp

    jq = _jq()
    q = np.random.default_rng(0).integers(-7, 8, size=(3, 64))
    packed = tq.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and packed.shape == (3, 32)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q, jnp.int32))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)
    # every byte, the never-produced -8 nibble (0x8) included
    every = torch.arange(-128, 128, dtype=torch.int8).reshape(4, 64)
    np.testing.assert_array_equal(
        tq.unpack_int4(every).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(every.numpy()))))


def test_roundtrip_and_f32_passthrough():
    x = _chunky(3, 2000, seed=3)
    tx = torch.from_numpy(x)
    assert torch.equal(tq.roundtrip(tx, "f32"), tx)
    assert tq.quantize(tx, "f32").scales is None
    for transport in ("bf16", "int8", "int4"):
        np.testing.assert_array_equal(
            tq.roundtrip(tx, transport).numpy(),
            tq.dequantize(tq.quantize(tx, transport)).numpy())


def test_wire_and_round_bytes_match_the_reference():
    jq = _jq()
    for k, n in ((4, CHUNK + 1), (10, 1_663_370), (1, 7)):
        for transport in tq.TRANSPORTS:
            for gs in (32, 512):
                assert tq.wire_bytes(k, n, transport, group_size=gs) == \
                    jq.wire_bytes(k, n, transport, group_size=gs)
        for down in tq.DOWNLINKS:
            assert tq.round_bytes(k, n, "int4", down) == \
                jq.round_bytes(k, n, "int4", down)
        assert tq.round_bytes(k, n, "int8", "bf16", delta_payloads=3,
                              full_clients=1) == \
            jq.round_bytes(k, n, "int8", "bf16", delta_payloads=3,
                           full_clients=1)
    with pytest.raises(ValueError, match="downlink"):
        tq.round_bytes(4, 100, "int8", "int4")
    with pytest.raises(ValueError, match="together"):
        tq.round_bytes(4, 100, "int8", "bf16", delta_payloads=1)
    with pytest.raises(ValueError, match="transport"):
        tq.wire_bytes(4, 100, "fp8")


@pytest.mark.parametrize("gs", [0, 1, 3, 7, 100, CHUNK + 2, 2 * CHUNK, 512.0])
def test_bad_group_size_raises(gs):
    with pytest.raises(ValueError, match="group_size"):
        tq.validate_group_size(gs)
    with pytest.raises(ValueError, match="group_size"):
        tq.quantize(torch.zeros((1, 64)), "int4", group_size=gs)


def test_every_even_divisor_of_the_chunk_is_a_group_size():
    for lg in range(1, 15):
        tq.validate_group_size(1 << lg)
    with pytest.raises(ValueError, match="transport"):
        tq.quantize(torch.zeros((1, 8)), "fp8")


def test_error_feedback_buffer():
    ef = tq.init_error_feedback(6, 100, device="cpu")
    assert ef.shape == (6, 100) and ef.dtype == torch.float32
    assert ef.device.type == "cpu" and not ef.any()


def test_error_feedback_buffer_is_on_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.init_error_feedback(2, 3)


# ------------------------------------------------ kernels: plain vs Pallas


def _g_and_w(k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,)).astype(np.float32),
            rng.uniform(size=(k,)).astype(np.float32))


def _wire(k, n, transport, gs=tq.GROUP_SIZE, seed=0):
    """The port's wire of chunky data, and the same wire as jax arrays."""
    import jax.numpy as jnp

    block = gs if transport == "int4" else CHUNK
    q = tq.quantize(torch.from_numpy(_chunky(k, n, block, seed)), transport,
                    group_size=gs)
    return q, jnp.asarray(q.values.numpy()), jnp.asarray(q.scales.numpy())


def _close_ref(got, want, rtol, atol=0.0):
    for a, b, name in zip(got, want, ("dots", "sqs", "sqg")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("k", CHUNK_KS)
@pytest.mark.parametrize("n", NS)
def test_weighted_agg_q_matches_pallas(k, n):
    import jax.numpy as jnp
    from repro.kernels import weighted_agg as jwa

    q, jv, js = _wire(k, n, "int8", seed=k + n)
    _, w = _g_and_w(k, n, seed=n)
    got = twa.weighted_agg_q(torch.from_numpy(w), q.values, q.scales)
    want = np.asarray(jwa.weighted_agg_q(jnp.asarray(w), jv, js))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert_agg_close(got.numpy(), want, w, tq.dequantize(q).numpy())


@pytest.mark.parametrize("k", CHUNK_KS)
@pytest.mark.parametrize("n", NS)
def test_round_stats_q_matches_pallas(k, n):
    import jax.numpy as jnp
    from repro.kernels import round_stats as jrs

    q, jv, js = _wire(k, n, "int8", seed=k * n)
    g, _ = _g_and_w(k, n, seed=n)
    got = trs.round_stats_q(q.values, q.scales, torch.from_numpy(g))
    want = jrs.round_stats_q(jv, js, jnp.asarray(g))
    assert [tuple(t.shape) for t in got] == [(k,), (k,), ()]
    _close_ref(got, want, rtol=1e-3, atol=1e-2)
    assert_stats_close([t.numpy() for t in got], want,
                       tq.dequantize(q).numpy(), g, None)


@pytest.mark.parametrize("k", CHUNK_KS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_weighted_agg_q4_matches_pallas(k, n, gs):
    import jax.numpy as jnp
    from repro.kernels import weighted_agg as jwa

    q, jv, js = _wire(k, n, "int4", gs, seed=k + n + gs)
    _, w = _g_and_w(k, n, seed=gs)
    got = twa.weighted_agg_q4(torch.from_numpy(w), q.values, q.scales, n=n,
                              group_size=gs)
    want = np.asarray(jwa.weighted_agg_q4(jnp.asarray(w), jv, js, n=n,
                                          group_size=gs))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert_agg_close(got.numpy(), want, w, tq.dequantize(q).numpy())


@pytest.mark.parametrize("k", CHUNK_KS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_round_stats_q4_matches_pallas(k, n, gs):
    import jax.numpy as jnp
    from repro.kernels import round_stats as jrs

    q, jv, js = _wire(k, n, "int4", gs, seed=k * gs + n)
    g, _ = _g_and_w(k, n, seed=k)
    got = trs.round_stats_q4(q.values, q.scales, torch.from_numpy(g),
                             group_size=gs)
    want = jrs.round_stats_q4(jv, js, jnp.asarray(g), group_size=gs)
    _close_ref(got, want, rtol=2e-3, atol=1e-2)
    assert_stats_close([t.numpy() for t in got], want,
                       tq.dequantize(q).numpy(), g, None)


@pytest.mark.parametrize("transport,gs,lo,hi", [
    ("int8", 512, CHUNK - 501, CHUNK + 499),  # across the scale chunk
    ("int4", 512, 512 - 101, CHUNK + 501),  # across a group and the chunk
    ("int4", 32, 31, 2 * CHUNK + 3),  # odd edges, many groups
])
def test_masked_stats_match_pallas(transport, gs, lo, hi):
    """K = 33 across the reference's client chunk; the mask's edges are
    odd offsets, so the masked span starts on a high nibble and ends on a
    low one; the mask must bite."""
    import jax.numpy as jnp
    from repro.kernels import round_stats as jrs

    k, n = 33, 2 * CHUNK + 600
    q, jv, js = _wire(k, n, transport, gs, seed=lo)
    g, _ = _g_and_w(k, n, seed=hi)
    mask = np.ones(n, np.float32)
    mask[lo:hi] = 0.0
    tg, tm = torch.from_numpy(g), torch.from_numpy(mask)
    if transport == "int4":
        got = trs.round_stats_q4(q.values, q.scales, tg, tm, group_size=gs)
        want = jrs.round_stats_q4(jv, js, jnp.asarray(g), jnp.asarray(mask),
                                  group_size=gs)
        full = trs.round_stats_q4(q.values, q.scales, tg, group_size=gs)
    else:
        got = trs.round_stats_q(q.values, q.scales, tg, tm)
        want = jrs.round_stats_q(jv, js, jnp.asarray(g), jnp.asarray(mask))
        full = trs.round_stats_q(q.values, q.scales, tg)
    _close_ref(got, want, rtol=2e-3)
    assert_stats_close([t.numpy() for t in got], want,
                       tq.dequantize(q).numpy(), g, mask)
    assert not np.allclose(got[1].numpy(), full[1].numpy())


def test_q4_odd_n_padding_nibble_adds_nothing():
    """Odd N: the last byte's high nibble is padding. The port matches the
    reference on the quantizer's wire (padding 0), and a nonzero padding
    nibble changes nothing: it never meets g[N], mask[N] or y[N]."""
    import jax.numpy as jnp
    from repro.kernels import round_stats as jrs
    from repro.kernels import weighted_agg as jwa

    k, n, gs = 3, 2 * CHUNK + 1, 512
    q, jv, js = _wire(k, n, "int4", gs, seed=16)
    g, w = _g_and_w(k, n, seed=17)
    tg, tw = torch.from_numpy(g), torch.from_numpy(w)
    stats = trs.round_stats_q4(q.values, q.scales, tg, group_size=gs)
    _close_ref(stats, jrs.round_stats_q4(jv, js, jnp.asarray(g),
                                         group_size=gs), rtol=2e-3, atol=1e-2)
    y = twa.weighted_agg_q4(tw, q.values, q.scales, n=n, group_size=gs)
    assert_agg_close(y.numpy(), np.asarray(jwa.weighted_agg_q4(
        jnp.asarray(w), jv, js, n=n, group_size=gs)), w,
        tq.dequantize(q).numpy())
    dirty = q.values.clone()
    dirty[:, -1] |= torch.tensor(0x70, dtype=torch.int8)  # padding := 7
    for a, b in zip(stats, trs.round_stats_q4(dirty, q.scales, tg,
                                              group_size=gs)):
        assert torch.equal(a, b)
    assert torch.equal(y, twa.weighted_agg_q4(tw, dirty, q.scales, n=n,
                                              group_size=gs))


@pytest.mark.parametrize("k", [1, 33])
def test_bf16_wire_through_the_f32_wrappers(k):
    """The bf16 wire has no scales: the f32 kernels' plain versions widen
    it to f32; `out_dtype=torch.float32` keeps the sum in f32 and the
    default follows x.dtype, as the reference's."""
    import jax.numpy as jnp
    from repro.kernels import round_stats as jrs
    from repro.kernels import weighted_agg as jwa

    n = CHUNK + 1
    x = _chunky(k, n, seed=6)
    g, w = _g_and_w(k, n, seed=7)
    wire = tq.quantize(torch.from_numpy(x), "bf16").values
    jwire = jnp.asarray(x).astype(jnp.bfloat16)
    xf = wire.float().numpy()
    got = twa.weighted_agg(torch.from_numpy(w), wire,
                           out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = np.asarray(jwa.weighted_agg(jnp.asarray(w), jwire,
                                       out_dtype=jnp.float32,
                                       min_kernel_elems=0))
    assert_agg_close(got.numpy(), want, w, xf)
    assert twa.weighted_agg(torch.from_numpy(w), wire).dtype == \
        torch.bfloat16
    stats = trs.round_stats(wire, torch.from_numpy(g))
    jstats = jrs.round_stats(jwire, jnp.asarray(g), min_kernel_elems=0)
    assert_stats_close([t.numpy() for t in stats], jstats, xf, g, None)


def test_wrappers_check_the_wire_shapes():
    n, gs = 1001, 32
    q = tq.quantize(torch.randn(3, n), "int4", group_size=gs)
    w, g = torch.ones(3), torch.randn(n)
    with pytest.raises(ValueError, match="packed"):
        twa.weighted_agg_q4(w, q.values[:, :-1].contiguous(), q.scales,
                            n=n, group_size=gs)
    with pytest.raises(ValueError, match="packed"):
        trs.round_stats_q4(q.values, q.scales, g[:-2], group_size=gs)
    with pytest.raises(ValueError, match="group_size"):
        twa.weighted_agg_q4(w, q.values, q.scales, n=n, group_size=48)
    with pytest.raises(ValueError, match="group_size"):
        trs.round_stats_q4(q.values, q.scales, g, group_size=3)
    with pytest.raises(ValueError, match="scales"):
        twa.weighted_agg_q4(w, q.values, q.scales, n=n, group_size=64)
    q8 = tq.quantize(torch.randn(3, CHUNK + 1), "int8")
    with pytest.raises(ValueError, match="scales"):
        twa.weighted_agg_q(w, q8.values, q8.scales[:, :1])
    with pytest.raises(ValueError, match="mask"):
        trs.round_stats_q(q8.values, q8.scales, torch.randn(CHUNK + 1),
                          torch.ones(CHUNK))
    with pytest.raises(ValueError, match="w must"):
        twa.weighted_agg_q(torch.ones(2), q8.values, q8.scales)


def test_cpu_wire_kernels_count_nothing():
    q8 = tq.quantize(torch.randn(3, 100), "int8")
    q4 = tq.quantize(torch.randn(3, 100), "int4", group_size=32)
    w, g = torch.ones(3), torch.randn(100)
    before = (twa.weighted_agg_q.launches, twa.weighted_agg_q4.launches,
              trs.round_stats_q.launches, trs.round_stats_q4.launches)
    twa.weighted_agg_q(w, q8.values, q8.scales)
    twa.weighted_agg_q4(w, q4.values, q4.scales, n=100, group_size=32)
    trs.round_stats_q(q8.values, q8.scales, g)
    trs.round_stats_q4(q4.values, q4.scales, g, group_size=32)
    assert before == (twa.weighted_agg_q.launches,
                      twa.weighted_agg_q4.launches,
                      trs.round_stats_q.launches,
                      trs.round_stats_q4.launches)


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestWireOnCard:
    """The wire kernels against their plain versions on the card, at the
    main path's shape and edge shapes (chip_smoke.py runs the same
    comparison with timings), and the quantizer on the card against the
    quantizer on the CPU."""

    SHAPES = [(10, 1_663_370), (1, 7850), (3, 16385), (37, 1_000_003),
              (128, 7850), (4, 4099)]

    @staticmethod
    def _dev_wire(k, n, transport, gs, dev):
        x = torch.from_numpy(_chunky(k, n, gs if transport == "int4"
                                     else CHUNK, seed=n))
        return tq.quantize(x.to(dev), transport, group_size=gs)

    @staticmethod
    def _mask(n, dev):
        mask = torch.ones(n)
        mask[n // 3 + 1: n // 3 + 1 + max(1, n // 4)] = 0.0
        return mask.to(dev)

    @pytest.mark.parametrize("transport", ["bf16", "int8", "int4"])
    def test_quantize_on_card_equals_cpu(self, cuda_device, transport):
        x = _chunky(10, 1_663_370, block=512, seed=1)
        a = tq.quantize(torch.from_numpy(x).to(cuda_device), transport)
        b = tq.quantize(torch.from_numpy(x), transport)
        assert torch.equal(a.values.cpu(), b.values)
        if b.scales is not None:
            assert torch.equal(a.scales.cpu(), b.scales)

    @pytest.mark.parametrize("transport,gs", [
        ("int8", tq.GROUP_SIZE), ("int4", 2), ("int4", 8), ("int4", 32),
        ("int4", 512), ("int4", CHUNK)])
    @pytest.mark.parametrize("k,n", SHAPES)
    def test_wire_kernels(self, cuda_device, k, n, transport, gs):
        q = self._dev_wire(k, n, transport, gs, cuda_device)
        g, w = (torch.from_numpy(a).to(cuda_device)
                for a in _g_and_w(k, n, seed=1))
        x = tq.dequantize(q)
        agg = twa.weighted_agg_q4 if transport == "int4" else \
            twa.weighted_agg_q
        stats = trs.round_stats_q4 if transport == "int4" else \
            trs.round_stats_q
        kw = dict(group_size=gs) if transport == "int4" else {}
        akw = dict(kw, n=n) if transport == "int4" else {}
        before = (agg.launches, stats.launches)
        y = agg(w, q.values, q.scales, **akw)
        want = getattr(twa, agg.__name__ + "_plain")(w, q.values, q.scales,
                                                    **akw)
        assert_agg_close(y.cpu().numpy(), want.cpu().numpy(),
                         w.cpu().numpy(), x.cpu().numpy())
        for m in (None, self._mask(n, cuda_device)):
            got = stats(q.values, q.scales, g, m, **kw)
            ref = getattr(trs, stats.__name__ + "_plain")(
                q.values, q.scales, g, m, **kw)
            assert_stats_close(
                [t.cpu().numpy() for t in got],
                [t.cpu().numpy() for t in ref], x.cpu().numpy(),
                g.cpu().numpy(), None if m is None else m.cpu().numpy())
            again = stats(q.values, q.scales, g, m, **kw)
            for a, b in zip(got, again):  # no atomics: the same bits
                assert torch.equal(a, b)
        torch.cuda.synchronize()
        assert (agg.launches, stats.launches) == (before[0] + 1,
                                                  before[1] + 4)

    @pytest.mark.parametrize("k,n", SHAPES)
    def test_bf16_input_of_the_f32_kernels(self, cuda_device, k, n):
        x = torch.from_numpy(_chunky(k, n, seed=2)).to(cuda_device)
        wire = x.to(torch.bfloat16)
        g, w = (torch.from_numpy(a).to(cuda_device)
                for a in _g_and_w(k, n, seed=3))
        xf = wire.float().cpu().numpy()
        y = twa.weighted_agg(w, wire, out_dtype=torch.float32)
        assert_agg_close(y.cpu().numpy(), twa.weighted_agg_plain(
            w, wire, torch.float32).cpu().numpy(), w.cpu().numpy(), xf)
        for m in (None, self._mask(n, cuda_device)):
            got = trs.round_stats(wire, g, m)
            assert_stats_close(
                [t.cpu().numpy() for t in got],
                [t.cpu().numpy() for t in trs.round_stats_plain(wire, g, m)],
                xf, g.cpu().numpy(), None if m is None else m.cpu().numpy())

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, cuda_device):
        q = tq.quantize(torch.randn(3, 100, device=cuda_device), "int8")
        w = torch.ones(3, device=cuda_device)
        with pytest.raises(TypeError):
            twa.weighted_agg_q(w, q.values.to(torch.uint8), q.scales)
        with pytest.raises(TypeError):
            trs.round_stats_q(q.values, q.scales,
                              torch.zeros(100, device=cuda_device).double())
        with pytest.raises(ValueError):
            trs.round_stats_q(q.values, q.scales, torch.zeros(100))
