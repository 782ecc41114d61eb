"""Server->client broadcast (downlink) compression, in torch.

The port's own copy of `repro/transport/downlink.py`. The uplink
(`transport.quantize`) compresses the K stacked client deltas; this
module compresses the other half of a round's traffic, the global model
the server broadcasts. `FLConfig(downlink="f32" | "bf16" | "int8")`
selects the format: the round compresses the raveled (N,) parameter
vector once as a (1, N) row of the uplink's wire formats (int8: one f32
scale per CHUNK), and every client trains from the same dequantized
reconstruction, so the engines cannot fork. downlink="f32" is the
reference broadcast.

Error feedback (`FLConfig(downlink_error_feedback=True)`): the broadcast
residual p - dequantize(quantize(p)) is carried across rounds (one (N,)
f32 vector, `RoundState.dl_ef`) and added back before the next
compression.

Delta encoding (`FLConfig(downlink_delta=True)`): the round compresses
the diff between the params and the broadcast chain head B_{v-1}; the
chain B_v = B_{v-1} + dequantize(q_v) starts from zeros, so version 0
ships the full model.

Per-client state (`BroadcastState`, `RoundState.bcast`): under partial
participation or buffered admission a client does not receive every
broadcast, and decodes against the last version it pulled. The server
keeps the delta reconstructions of the last R versions (`ring`, slot
v % R), the chain head (`head`, version `head_ver`), and each client's
last-pulled version (`ver`, `NEVER_PULLED` = -1 before its first pull).
A client at version w replays the ring's rows w+1..v onto its base in
version order, the same f32 additions as the server chain, so the decode
is bitwise `head` (`client_decode`). A client that never pulled or is
more than R versions behind needs a full-model resync (`resync_mask`);
the simulation hands it the head (the bytes of a full payload are what
such a pull costs on the wire).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

import repro_torch
from repro_torch.transport.quantize import (
    DOWNLINKS,
    QuantizedDelta,
    dequantize,
    quantize,
)

# `BroadcastState.ver` of a client that never pulled a broadcast: it
# cannot delta-decode and must receive a full model.
NEVER_PULLED = -1


def compress(vec: torch.Tensor, downlink: str) -> QuantizedDelta:
    """Compress an (N,) f32 parameter vector into the downlink format, as
    one (1, N) row of the uplink's wire."""
    if downlink not in DOWNLINKS:
        raise ValueError(f"unknown downlink {downlink!r} "
                         f"(expected one of {DOWNLINKS})")
    return quantize(vec[None, :], downlink)


def decompress(q: QuantizedDelta) -> torch.Tensor:
    """(N,) f32 reconstruction: what every client trains from."""
    return dequantize(q)[0]


def broadcast_roundtrip(vec: torch.Tensor, downlink: str) -> torch.Tensor:
    """decompress(compress(vec)): the reconstruction the clients see."""
    if downlink == "f32":
        return vec.to(torch.float32)
    return decompress(compress(vec, downlink))


def init_downlink_error_feedback(n: int, device=None) -> torch.Tensor:
    """(N,) f32 server-side broadcast residual (one copy: the broadcast is
    the same for every client), on `device` (CUDA when None: raises
    without a GPU)."""
    dev = repro_torch.default_device() if device is None else device
    return torch.zeros((n,), dtype=torch.float32, device=dev)


def delta_compress(vec: torch.Tensor, prev: torch.Tensor,
                   downlink: str) -> QuantizedDelta:
    """Compress the (N,) broadcast diff `vec - prev` (`prev` is the
    reconstruction the clients already hold)."""
    return compress(vec - prev, downlink)


def delta_decompress(q: QuantizedDelta, prev: torch.Tensor) -> torch.Tensor:
    """(N,) f32 reconstruction the clients advance to: prev + deq(q)."""
    return prev + decompress(q)


def delta_roundtrip(vec: torch.Tensor, prev: torch.Tensor,
                    downlink: str) -> torch.Tensor:
    """delta_decompress(delta_compress(vec)): one delta-encoded hop."""
    if downlink == "f32":
        return vec.to(torch.float32)
    return delta_decompress(delta_compress(vec, prev, downlink), prev)


class BroadcastState(NamedTuple):
    """Per-client downlink-delta bookkeeping (see the module docstring),
    carried in `fl.RoundState.bcast` when `FLConfig(downlink_delta=True)`.
    All four live on the state's device."""

    ring: torch.Tensor  # (R, N) f32: delta recon D_j of the last R versions
    head: torch.Tensor  # (N,) f32: chain reconstruction B_{head_ver}
    head_ver: torch.Tensor  # () int32: version of head; -1 before any
    ver: torch.Tensor  # (num_clients,) int32: last version each pulled


def init_broadcast_state(n: int, num_clients: int, ring: int,
                         device=None) -> BroadcastState:
    """Fresh BroadcastState on `device` (CUDA when None): an empty R-deep
    ring, a zero head (the first delta-encoded broadcast ships the full
    model), and every client `NEVER_PULLED`."""
    if ring < 1:
        raise ValueError(f"downlink ring depth must be >= 1, got {ring}")
    dev = repro_torch.default_device() if device is None else device
    return BroadcastState(
        ring=torch.zeros((ring, n), dtype=torch.float32, device=dev),
        head=torch.zeros((n,), dtype=torch.float32, device=dev),
        head_ver=torch.tensor(NEVER_PULLED, dtype=torch.int32, device=dev),
        ver=torch.full((num_clients,), NEVER_PULLED, dtype=torch.int32,
                       device=dev),
    )


def resync_mask(ver_rows, v, ring: int) -> torch.Tensor:
    """True where a client at last-pulled version `ver_rows` cannot
    delta-decode version `v` and needs a full-model resync: it never
    pulled, or it is more than `ring` versions behind."""
    ver_rows = torch.as_tensor(ver_rows)
    return (ver_rows == NEVER_PULLED) | (v - ver_rows > ring)


def advance_broadcast(bstate: BroadcastState,
                      d_recon: torch.Tensor) -> BroadcastState:
    """Publish version v = head_ver + 1: write its delta reconstruction
    into ring slot v % R and advance the head to B_v = B_{v-1} + D_v.
    The round updates the per-client `ver` rows itself.

    The head adds the row read back from the new ring, not `d_recon`, as
    the reference does: the add then uses the stored bytes whatever a
    compiler would fuse into it, and a client replaying the ring lands
    bitwise on the head. The slot is a device tensor (no host sync), and
    the input state is left as it was."""
    v = bstate.head_ver + 1
    slot = torch.remainder(v, bstate.ring.shape[0]).to(torch.int64)
    slot = slot.reshape(1)
    ring = bstate.ring.index_copy(0, slot, d_recon[None])
    d_stored = ring.index_select(0, slot)[0]
    return bstate._replace(ring=ring, head=bstate.head + d_stored,
                           head_ver=v)


def client_decode(bstate: BroadcastState, base: torch.Tensor,
                  base_ver: int) -> torch.Tensor:
    """The client-side decoder: replay the ring's rows base_ver+1 ..
    head_ver onto the base the client holds, in version order; bitwise
    `bstate.head`. A host helper (a Python loop over at most R rows);
    raises ValueError when the client needs a full resync."""
    v = int(bstate.head_ver)
    w = int(base_ver)
    r = bstate.ring.shape[0]
    if w == NEVER_PULLED or v - w > r:
        raise ValueError(
            f"client at version {w} cannot delta-decode version {v} with "
            f"a {r}-deep ring: it needs a full-model resync")
    out = base
    for j in range(w + 1, v + 1):
        out = out + bstate.ring[j % r]
    return out
