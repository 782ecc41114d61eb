"""The FedAdp aggregation as an explicit collective schedule over a
client mesh (`launch.mesh.ClientMesh`), on `torch.distributed`.

The counterpart of `repro/core/fl_shard_map.py` on a client-only mesh.
Every rank runs the same call on the same global (replicated) arguments
and holds its own rows of the client axis, which is zero-padded to Kp, a
multiple of the mesh size; rank r holds rows [r Kp/P, (r+1) Kp/P)
(`flat_client_sharding`). A round is the reference's schedule, each
`jax.lax.psum` an `all_reduce`:

  per rank:    g = all_reduce(weighted_agg(psi[mine], x_mine))       (1)
               (dots, sqs) of the rank's rows scattered into a zero
               (2, Kp) block, all_reduced; ||g||^2 from the same g      (2)
  replicated:  theta -> Eq. 9 -> Gompertz softmax weights w           (3)
  per rank:    delta = all_reduce(weighted_agg(w[mine], x_mine))      (4)

Two (N,) f32 all-reduces and one (2, Kp) a round (fedavg / fedprox reuse
g, one N-wide all-reduce). Steps (1), (2) and (4) stream the rank's
(Kp/P, N) rows through the port's CUDA kernels, dequantizing the int8 /
int4 wire in registers; a scale never crosses ranks (the wire's chunks
are per row). After each call every rank holds the same bits.

`make_round_ops` is the sync round's region (`core.fl`'s
engine="flat_sharded"), `make_buffered_flush_ops` the buffered flush's,
and `fedadp_aggregate` the standalone per-leaf ("tree") and flat API.
The 2D (client x model) layout (`make_round_ops_2d`,
`make_blocked_roundtrip`) raises NotImplementedError naming ROADMAP
Queue 1 item 13b; a `ClientMesh` has no model axis.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import transport as transport_mod
from repro_torch.core import treemath, weighting
from repro_torch.kernels import round_stats as round_stats_mod
from repro_torch.kernels import weighted_agg as weighted_agg_mod

Tree = Any

NOT_2D = ("the 2D (client x model) mesh layout is not ported yet (ROADMAP "
          "Queue 1 item 13b); use a client-only mesh (model axis 1)")


def model_axis_size(mesh) -> int:
    """Size of the mesh's "model" axis: 1, since a ClientMesh has none
    (the 2D layout is item 13b)."""
    return 1


def client_axis_size(mesh) -> int:
    return int(mesh.size)


class RowShard(NamedTuple):
    """Rank `index` of `count`: its block of rows of a client axis whose
    length is a multiple of `count`."""

    index: int
    count: int

    def rows(self, k: int) -> slice:
        if k % self.count:
            raise ValueError(
                f"a client axis of {k} rows does not split over "
                f"{self.count} ranks; pad it to a multiple first")
        k_loc = k // self.count
        return slice(self.index * k_loc, (self.index + 1) * k_loc)


def flat_client_sharding(mesh) -> RowShard:
    """Row sharding of the (Kp, N) flat delta buffer: this rank's block."""
    return RowShard(mesh.rank, mesh.size)


def padded_k(k: int, size: int) -> int:
    """K rounded up to a multiple of `size`, the mesh's (the reference's
    `-(-k // csize) * csize`)."""
    return -(-k // size) * size


def replicate_rows(mesh, local: torch.Tensor, k: int) -> torch.Tensor:
    """The (k, ...) rows of a client axis on every rank, from each rank's
    `local` rows: its block of the axis padded to `padded_k`, cut at k
    (a rank past k holds none). One broadcast from each owning rank, so
    every bit (a -0.0 too) arrives as its owner computed it."""
    k_loc = padded_k(k, mesh.size) // mesh.size
    out = torch.empty((k,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    for r in range(mesh.size):
        part = out[r * k_loc:min((r + 1) * k_loc, k)]
        if part.shape[0] == 0:
            continue
        if r == mesh.rank:
            part.copy_(local)
        mesh.broadcast(part, r)
    return out


def _shard_slots(values: torch.Tensor, mesh) -> slice:
    """The global client slots of this rank's rows (the reference returns
    them as an index vector; a slice views them in place)."""
    return flat_client_sharding(mesh).rows(values.shape[0] * mesh.size)


def _shard_agg(w_loc, values, scales, *, transport, n, group_size):
    """The rank's weighted aggregation over its rows, f32 out: the f32
    kernel for f32 / bf16 rows (scales None), the int8 or int4 wire
    kernel otherwise (`n` is the logical width packed int4 rows unpack
    to)."""
    if scales is None:
        return weighted_agg_mod.weighted_agg(w_loc, values,
                                             out_dtype=torch.float32)
    if transport == "int4":
        return weighted_agg_mod.weighted_agg_q4(
            w_loc, values, scales, n=n, group_size=group_size)
    return weighted_agg_mod.weighted_agg_q(w_loc, values, scales)


def _shard_stats(values, scales, g_flat, mask, *, transport, group_size):
    """The rank's angle statistics over its rows."""
    if scales is None:
        return round_stats_mod.round_stats(values, g_flat, mask)
    if transport == "int4":
        return round_stats_mod.round_stats_q4(
            values, scales, g_flat, mask, group_size=group_size)
    return round_stats_mod.round_stats_q(values, scales, g_flat, mask)


def _all_stats(mesh, mine: slice, kp: int, d_loc, s_loc):
    """(dots, sqs), (Kp,) each on every rank: the rank's values at its
    slots of a zero (2, Kp) block, all_reduced once."""
    both = torch.zeros((2, kp), dtype=torch.float32, device=d_loc.device)
    both[0, mine] = d_loc
    both[1, mine] = s_loc
    mesh.all_reduce(both)
    return both[0], both[1]


def _smooth(theta, smoothed_sel, count_sel):
    """Eq. 9 with the reference's float ops (core.fl's scatter computes
    the same values for the state)."""
    cnt = count_sel.to(torch.float32) + 1.0
    return ((cnt - 1.0) * smoothed_sel + theta) / cnt


def make_round_ops(mesh, *, alpha: float, method: str = "fedadp",
                   transport: str = "f32", group_size: int = 0):
    """The whole aggregation round as one schedule over the mesh.

    Returns round_op(values[, scales], psi, mask, smoothed_sel,
    count_sel, data_sizes, *, n=None) -> (g_flat, dots, sqs, sqg,
    delta_flat, theta, theta_sm, w). `values` (and for "int8" / "int4"
    `scales`) is this rank's row block of the padded wire buffer
    (`flat_client_sharding(mesh).rows(Kp)`): f32 or bf16 (Kp/P, N), int8
    with its per-chunk scales, or packed int4 (Kp/P, ceil(N/2)) with its
    group scales. The rest is replicated: psi, smoothed_sel, count_sel and
    data_sizes (Kp,), and the (N,) f32 segment mask in logical width or
    None (unfiltered statistics, as the flat engine). The int4 wire's
    logical width N comes from the mask or, without one, from `n`. The
    eight outputs are the same on every rank; theta_sm is Eq. 9 by the
    reference's float ops, and fedavg / fedprox return w = psi with
    delta_flat = g_flat (one N-wide all-reduce)."""
    if transport == "int4":
        group_size = group_size or transport_mod.GROUP_SIZE
        transport_mod.validate_group_size(group_size)
    wired = transport in ("int8", "int4")

    def _body(values, scales, psi, mask, smoothed_sel, count_sel,
              data_sizes, *, n=None):
        mine = _shard_slots(values, mesh)
        if mask is not None:
            n = mask.shape[0]  # logical width (!= packed width for int4)
        if transport == "int4" and n is None:
            raise ValueError("the int4 wire needs its logical width: pass "
                             "a mask or n=")
        kw = dict(transport=transport, group_size=group_size)
        g_flat = mesh.all_reduce(
            _shard_agg(psi[mine], values, scales, n=n, **kw))
        d_loc, s_loc, sqg = _shard_stats(values, scales, g_flat, mask,
                                         **kw)
        dots, sqs = _all_stats(mesh, mine, psi.shape[0], d_loc, s_loc)
        theta = weighting.instantaneous_angle(dots, sqs, sqg)
        theta_sm = _smooth(theta, smoothed_sel, count_sel)
        if method == "fedadp":
            w = weighting.fedadp_weights(theta_sm, data_sizes, alpha)
            delta_flat = mesh.all_reduce(
                _shard_agg(w[mine], values, scales, n=n, **kw))
        else:  # w == psi: the statistics' aggregate is the round delta
            w = psi
            delta_flat = g_flat
        return g_flat, dots, sqs, sqg, delta_flat, theta, theta_sm, w

    if wired:
        return _body
    return lambda values, *rest, **kw: _body(values, None, *rest, **kw)


def make_round_ops_2d(mesh, template_stacked: Tree, pspecs: Tree, *,
                      alpha: float, method: str = "fedadp",
                      transport: str = "f32", group_size: int = 0,
                      keep=None):
    """The round on a 2D (client x model) mesh: not ported yet."""
    raise NotImplementedError(NOT_2D)


def make_blocked_roundtrip(mesh, template_stacked: Tree, pspecs: Tree, *,
                           transport: str, group_size: int = 0):
    """The shard-local wire roundtrip of a 2D mesh: not ported yet."""
    raise NotImplementedError(NOT_2D)


def make_buffered_flush_ops(mesh, *, alpha: float, method: str = "fedadp",
                            beta: float = 0.0):
    """The buffered-async flush as one schedule over the mesh:
    `make_round_ops`' steps over the report buffer's rows, which hold
    dequantized f32 reports on every wire (compression happened at
    admission), so the f32 kernels stream them. Step (3) is the
    staleness-aware weighting; a row that did not land (client-axis
    padding rows too, which must come in landed=False) gets weight 0.

    flush_op(values, psi, mask, smoothed_sel, count_sel, sizes, age,
    landed) -> (g_flat, dots, sqs, sqg, delta_flat, theta, theta_sm, w):
    `values` is this rank's (Kp/P, N) block of the buffer, the rest is
    replicated, as in `make_round_ops`."""

    def _body(values, psi, mask, smoothed_sel, count_sel, sizes, age,
              landed):
        mine = _shard_slots(values, mesh)
        g_flat = mesh.all_reduce(weighted_agg_mod.weighted_agg(
            psi[mine], values, out_dtype=torch.float32))
        d_loc, s_loc, sqg = round_stats_mod.round_stats(values, g_flat,
                                                        mask)
        dots, sqs = _all_stats(mesh, mine, psi.shape[0], d_loc, s_loc)
        theta = weighting.instantaneous_angle(dots, sqs, sqg)
        theta_sm = _smooth(theta, smoothed_sel, count_sel)
        if method == "fedadp":
            w = weighting.buffered_fedadp_weights(
                theta_sm, sizes, age, landed, alpha, beta)
        else:
            w = weighting.buffered_fedavg_weights(sizes, age, landed, beta)
        delta_flat = mesh.all_reduce(weighted_agg_mod.weighted_agg(
            w[mine], values, out_dtype=torch.float32))
        return g_flat, dots, sqs, sqg, delta_flat, theta, theta_sm, w

    return _body


def _spec_leaves(pspecs: Tree) -> list:
    """The per-leaf specs of a dict tree whose leaves are tuples (the
    reference's PartitionSpecs: one entry per dim, the client axis
    first, None for an unsharded dim), in sorted-key order."""
    if isinstance(pspecs, dict):
        return [s for k in sorted(pspecs) for s in _spec_leaves(pspecs[k])]
    return [pspecs]


def _all_reduce_tree(mesh, tree: Tree) -> Tree:
    """The sum of an f32 tree over the ranks: one all_reduce of its
    raveled leaves."""
    vec, unravel = treemath.tree_ravel(tree)
    return unravel(mesh.all_reduce(vec))


def fedadp_aggregate(mesh, delta_pspecs: Tree, *, alpha: float,
                     method: str = "fedadp", engine: str = "tree",
                     transport: str = "f32", group_size: int = 0):
    """An aggregation function over K-stacked deltas on a client mesh.

    `delta_pspecs` is the spec tree of the STACKED deltas (tuples, the
    client axis first). engine="tree" runs per-leaf reductions on the
    rank's rows; engine="flat" ravels them into a (K/P, N) row block and
    runs `make_round_ops` (client-only specs; `transport` compresses the
    block to the wire first). K must divide over the mesh.

    Returns agg(deltas, data_sizes, smoothed_prev, count_prev) ->
    (weighted_delta, theta, theta_smoothed, weights), the same on every
    rank: `deltas` is the whole stacked tree (every rank passes the
    same), smoothed_prev / count_prev the selected clients' angle slots
    (Eq. 9 is applied inside)."""
    if engine == "flat":
        return _fedadp_aggregate_flat(mesh, delta_pspecs, alpha=alpha,
                                      method=method, transport=transport,
                                      group_size=group_size)
    if engine != "tree":
        raise ValueError(f"unknown engine {engine!r}")
    if transport != "f32":
        raise ValueError(
            "the tree engine never reads quantized buffers (ROADMAP "
            "transport contract); use engine='flat' for transport="
            f"{transport!r}")
    shard = flat_client_sharding(mesh)

    def body(deltas, data_sizes, smoothed_prev, count_prev):
        k = data_sizes.shape[0]
        mine = shard.rows(k)
        local = treemath.tree_map(lambda x: x[mine], deltas)
        psi_avg = weighting.fedavg_weights(data_sizes)

        def wsum(w_full):
            """all_reduce over the ranks of w[k] * delta[k]."""
            return _all_reduce_tree(mesh, treemath.tree_weighted_sum(
                local, w_full[mine], torch.float32))

        g_avg = wsum(psi_avg)  # (1)
        dot_loc = treemath.tree_vdot_batched(local, g_avg)
        sq_loc = treemath.tree_sqnorm_batched(local)
        sqg = treemath.tree_sqnorm(g_avg)
        dots, sqs = _all_stats(mesh, mine, k, dot_loc, sq_loc)  # (2)
        theta = weighting.instantaneous_angle(dots, sqs, sqg)  # (3)
        theta_sm = _smooth(theta, smoothed_prev, count_prev)
        if method == "fedadp":
            w = weighting.fedadp_weights(theta_sm, data_sizes, alpha)
        else:
            w = psi_avg
        return wsum(w), theta, theta_sm, w  # (4)

    return body


def _fedadp_aggregate_flat(mesh, delta_pspecs: Tree, *, alpha: float,
                           method: str, transport: str = "f32",
                           group_size: int = 0):
    """The flat engine behind `fedadp_aggregate(engine="flat")`: the
    rank's rows raveled once (`treemath.tree_ravel_stacked` with the
    mesh's row sharding), compressed to the wire, through
    `make_round_ops`."""
    if transport == "int4" and not group_size:
        group_size = transport_mod.GROUP_SIZE
    for s in _spec_leaves(delta_pspecs):
        if any(e is not None for e in tuple(s or ())[1:]):
            raise ValueError(
                "engine='flat' ravels each client's delta into one "
                f"contiguous row and requires client-only sharding; got {s}"
                " (use engine='tree' for model-axis-sharded leaves)")
    round_op = make_round_ops(mesh, alpha=alpha, method=method,
                              transport=transport, group_size=group_size)
    row_sharding = flat_client_sharding(mesh)

    def body(deltas, data_sizes, smoothed_prev, count_prev):
        flat, unravel = treemath.tree_ravel_stacked(deltas, row_sharding)
        psi_avg = weighting.fedavg_weights(data_sizes)
        if transport == "f32":
            wire = (flat,)
        else:
            q = transport_mod.quantize(flat, transport,
                                       group_size=group_size
                                       or transport_mod.GROUP_SIZE)
            wire = (q.values,) if q.scales is None else (q.values, q.scales)
        _, _, _, _, delta_flat, theta, theta_sm, w = round_op(
            *wire, psi_avg, None, smoothed_prev, count_prev, data_sizes,
            n=flat.shape[1])
        return unravel(delta_flat, torch.float32), theta, theta_sm, w

    return body


def pad_rows(a: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """Pad axis 0 to `rows` with `fill` (client-axis padding; `a` itself
    when it has them). Padding rows carry zero deltas and zero data
    size, so they get exactly zero weight and zero statistics."""
    short = rows - a.shape[0]
    if not short:
        return a
    pad = torch.full((short,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad])


def local_block(a: torch.Tensor, kp: int, shard: RowShard,
                fill=0) -> torch.Tensor:
    """`shard`'s block of `a` (K rows) padded to `kp` rows with `fill`,
    without building the whole padded array (a view of `a` when no row
    of the block is padding)."""
    mine = shard.rows(kp)
    k = a.shape[0]
    return pad_rows(a[min(mine.start, k):min(mine.stop, k)],
                    mine.stop - mine.start, fill)
