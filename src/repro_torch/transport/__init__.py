"""Delta transport: the client->server uplink wire of the round.

`quantize` compresses a client-stacked (K, N) f32 delta buffer into the
configured wire format (f32 passthrough, bf16 cast, int8 with per-chunk
f32 scales, int4 packed two params per byte with grouped scales). The
flat engine's kernels read the wire buffer directly and dequantize in
registers (`kernels.weighted_agg.weighted_agg_q{,4}`,
`kernels.round_stats.round_stats_q{,4}`); the tree engine never reads
it: it dequantizes back to the stacked tree first.

The port's counterpart of `repro/transport`; the quantized and delta
downlink (`repro/transport/downlink.py`) is not ported yet (ROADMAP
Queue 1 item 9).
"""
from repro_torch.transport.quantize import (  # noqa: F401
    CHUNK,
    DOWNLINKS,
    GROUP_SIZE,
    TRANSPORTS,
    QuantizedDelta,
    dequantize,
    init_error_feedback,
    num_chunks,
    num_groups,
    pack_int4,
    quantize,
    round_bytes,
    roundtrip,
    unpack_int4,
    validate_group_size,
    wire_bytes,
)
