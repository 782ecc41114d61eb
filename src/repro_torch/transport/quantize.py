"""Client-uplink delta quantization with kernel-aligned scales, in torch.

The port's own copy of `repro/transport/quantize.py`. Wire formats over
the flat (K, N) client-delta buffer:

* ``f32``  - identity; the reference wire format.
* ``bf16`` - elementwise cast, 2 bytes/param, no side data. Dequant is the
  f32 load inside `weighted_agg` / `round_stats`.
* ``int8`` - symmetric per-chunk quantization, 1 byte/param plus one f32
  scale per (client, CHUNK-wide chunk): q = round(x / s) in [-127, 127]
  with s = absmax(chunk) / 127.
* ``int4`` - symmetric GROUPED quantization, two params per byte (byte j
  holds logical elements 2j and 2j+1 in its low and high nibble), plus
  one f32 scale per (client, group): q = round(x / s) in [-7, 7] with
  s = absmax(group) / 7. `group_size` is an even divisor of CHUNK, so a
  byte never straddles a group.

The quantizer is plain tensor code in the reference too (no Pallas
kernel), and here it reproduces the reference BIT FOR BIT: the same f32
divide `x / s` (no reciprocal multiply), round half to even
(`torch.round`), clipping to +-127 or +-7, scale 1.0 for all-zero chunks
or groups, low nibble first, even-width packing for odd N. It runs on
whatever device its input lies on; on the card each step is one of
PyTorch's elementwise or reduction kernels.

Error feedback (`FLConfig(error_feedback=True)`): the residual
x - dequantize(quantize(x)) is carried per population client and added
to the next round's delta before quantization (EF-SGD).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

import repro_torch

# One f32 scale per CHUNK wire values per client: the (128, 128) tile the
# reference's kernels stream per grid step.
CHUNK = 128 * 128

# Default int4 scale-group width: one f32 scale per 256 wire bytes.
GROUP_SIZE = 512

TRANSPORTS = ("f32", "bf16", "int8", "int4")
# Formats the reference accepts for the server->client broadcast.
DOWNLINKS = ("f32", "bf16", "int8")

_DTYPE_FMT = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.int8: "int8"}


class QuantizedDelta(NamedTuple):
    """Wire-format view of a (K, N) client-delta buffer.

    values: (K, N) in the wire dtype for f32/bf16/int8; for int4 the
      PACKED (K, ceil(N/2)) int8 buffer (two nibbles per byte).
    scales: f32 dequant multipliers, (K, num_chunks(N)) for int8,
      (K, num_groups(N, group_size)) for int4, else None.
    fmt: wire format name; "" infers it from the values dtype.
    n: logical element count (int4 only; packing loses N's parity), -1
      when the values are unpacked.
    group_size: int4 scale-group width; 0 for the other formats.
    """

    values: torch.Tensor
    scales: Optional[torch.Tensor]
    fmt: str = ""
    n: int = -1
    group_size: int = 0

    @property
    def transport(self) -> str:
        return self.fmt or _DTYPE_FMT[self.values.dtype]


def num_chunks(n: int) -> int:
    """int8 scale columns for an N-wide buffer."""
    return max(1, -(-n // CHUNK))


def num_groups(n: int, group_size: int = GROUP_SIZE) -> int:
    """int4 scale columns for an N-wide buffer (one per group)."""
    return max(1, -(-n // group_size))


def validate_group_size(group_size: int) -> None:
    """int4 group contract: even (a packed byte never straddles a group)
    and a divisor of CHUNK, in [2, CHUNK]. Raises ValueError otherwise."""
    if (not isinstance(group_size, int) or not 2 <= group_size <= CHUNK
            or group_size % 2 or CHUNK % group_size):
        raise ValueError(
            f"int4 group_size must be an even divisor of CHUNK={CHUNK} in "
            f"[2, {CHUNK}]; got {group_size!r}")


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - x.shape[1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _absmax_scales(xg: torch.Tensor, qmax: float) -> torch.Tensor:
    absmax = torch.amax(torch.abs(xg), dim=2)
    # The divisor is a tensor, not a Python number: on CUDA, PyTorch turns
    # a division by a scalar into a multiply by its reciprocal, which
    # rounds differently from the reference's f32 divide.
    scales = absmax / torch.full_like(absmax, qmax)
    # all-zero chunks get scale 1 (they quantize to zeros) instead of 0/0
    return torch.where(absmax > 0.0, scales, torch.ones_like(absmax))


def _quantize_int8(flat: torch.Tensor) -> QuantizedDelta:
    k, n = flat.shape
    c = num_chunks(n)
    xp = _pad_cols(flat.to(torch.float32), c * CHUNK).reshape(k, c, CHUNK)
    scales = _absmax_scales(xp, 127.0)
    q = torch.clamp(torch.round(xp / scales[:, :, None]), -127.0, 127.0)
    values = q.to(torch.int8).reshape(k, c * CHUNK)[:, :n].contiguous()
    return QuantizedDelta(values, scales, "int8")


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack an even-width (K, 2M) int tensor in [-7, 7] to (K, M) int8:
    byte j = (q[2j] & 0xF) | (q[2j+1] << 4)."""
    k, n2 = q.shape
    assert n2 % 2 == 0, n2
    qi = q.to(torch.int32)
    b = (qi[:, 0::2] & 0xF) | ((qi[:, 1::2] & 0xF) << 4)  # [0, 255]
    return b.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(K, M) int8 -> (K, 2M) int32 nibbles in [-8, 7], in logical order
    (low nibble first). The int32 upcast sign-extends the byte; `& 0xF`
    isolates a nibble and `^ 8 - 8` re-extends the nibble's own sign."""
    bi = packed.to(torch.int32)
    lo = ((bi & 0xF) ^ 8) - 8
    hi = (((bi >> 4) & 0xF) ^ 8) - 8
    k, m = packed.shape
    return torch.stack([lo, hi], dim=-1).reshape(k, 2 * m)


def _quantize_int4(flat: torch.Tensor, group_size: int) -> QuantizedDelta:
    validate_group_size(group_size)
    k, n = flat.shape
    g = num_groups(n, group_size)
    total = g * group_size
    xg = _pad_cols(flat.to(torch.float32), total).reshape(k, g, group_size)
    scales = _absmax_scales(xg, 7.0)
    q = torch.clamp(torch.round(xg / scales[:, :, None]), -7.0, 7.0)
    # group_size is even, so the minimal even width covering n never
    # splits a byte
    ne = n + (n % 2)
    values = pack_int4(q.reshape(k, total)[:, :ne].to(torch.int32))
    return QuantizedDelta(values, scales, "int4", n, group_size)


def quantize(flat: torch.Tensor, transport: str, *,
             group_size: int = GROUP_SIZE) -> QuantizedDelta:
    """Compress a (K, N) f32 delta buffer into the wire format.
    `group_size` applies to int4 only."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r} "
                         f"(expected one of {TRANSPORTS})")
    if transport == "f32":
        return QuantizedDelta(flat.to(torch.float32), None, "f32")
    if transport == "bf16":
        return QuantizedDelta(flat.to(torch.bfloat16), None, "bf16")
    if transport == "int4":
        return _quantize_int4(flat, group_size)
    return _quantize_int8(flat)


def dequantize(q: QuantizedDelta) -> torch.Tensor:
    """(K, N) f32 reconstruction: the reference the kernels match."""
    if q.scales is None:
        return q.values.to(torch.float32)
    k = q.values.shape[0]
    if q.transport == "int4":
        if q.n < 0:
            raise ValueError(
                "int4 QuantizedDelta needs its logical width (n); construct "
                "it through transport.quantize")
        g, gs = q.scales.shape[1], q.group_size
        x = _pad_cols(unpack_int4(q.values).to(torch.float32), g * gs)
        x = (x.reshape(k, g, gs) * q.scales[:, :, None]).reshape(k, g * gs)
        return x[:, :q.n]
    n = q.values.shape[1]
    c = q.scales.shape[1]
    xp = _pad_cols(q.values.to(torch.float32), c * CHUNK).reshape(k, c, CHUNK)
    return (xp * q.scales[:, :, None]).reshape(k, c * CHUNK)[:, :n]


def roundtrip(flat: torch.Tensor, transport: str, *,
              group_size: int = GROUP_SIZE) -> torch.Tensor:
    """dequantize(quantize(x)): the tree engine's view of the wire."""
    if transport == "f32":
        return flat.to(torch.float32)
    return dequantize(quantize(flat, transport, group_size=group_size))


def wire_bytes(k: int, n: int, transport: str, *,
               group_size: int = GROUP_SIZE) -> int:
    """Uplink bytes for K clients x N params (values + scale side data)."""
    if transport == "f32":
        return k * n * 4
    if transport == "bf16":
        return k * n * 2
    if transport == "int8":
        return k * n * 1 + k * num_chunks(n) * 4
    if transport == "int4":
        return k * -(-n // 2) + k * num_groups(n, group_size) * 4
    raise ValueError(f"unknown transport {transport!r}")


def round_bytes(k: int, n: int, transport: str, downlink: str = "f32", *,
                group_size: int = GROUP_SIZE,
                delta_payloads: int | None = None,
                full_clients: int | None = None) -> dict:
    """Both directions of one round's wire traffic, in bytes.

    up: K client uplinks of the delta buffer in `transport`; down: K
    unicast broadcasts of one N-param payload in `downlink`; total: up +
    down. With `delta_payloads` and `full_clients` (passed together: the
    delta/full split of a delta-encoded downlink) the dict also carries
    "down_delta" and "down_full", each payload priced at
    `wire_bytes(1, n, downlink)`."""
    if downlink not in DOWNLINKS:
        raise ValueError(f"unknown downlink {downlink!r} "
                         f"(expected one of {DOWNLINKS})")
    if (delta_payloads is None) != (full_clients is None):
        raise ValueError("delta_payloads and full_clients must be "
                         "passed together (the delta/full split of one "
                         "round's downlink)")
    up = wire_bytes(k, n, transport, group_size=group_size)
    unit = wire_bytes(1, n, downlink)
    if delta_payloads is None:
        down = k * unit
        return {"up": up, "down": down, "total": up + down}
    down_delta = delta_payloads * unit
    down_full = full_clients * unit
    down = down_delta + down_full
    return {"up": up, "down": down, "down_delta": down_delta,
            "down_full": down_full, "total": up + down}


def init_error_feedback(num_clients: int, n: int,
                        device=None) -> torch.Tensor:
    """(num_clients, N) f32 residual carry, one row per population slot,
    on `device` (CUDA when None: raises without a GPU)."""
    dev = repro_torch.default_device() if device is None else device
    return torch.zeros((num_clients, n), dtype=torch.float32, device=dev)
