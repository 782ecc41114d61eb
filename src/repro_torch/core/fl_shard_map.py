"""The FedAdp aggregation as an explicit collective schedule over a
client mesh (`launch.mesh.ClientMesh`), on `torch.distributed`.

The counterpart of `repro/core/fl_shard_map.py`. Every rank runs the
same call on the same global (replicated) arguments and holds its own
rows of the client axis ("data"), which is zero-padded to Kp, a
multiple of that axis's size C; client index c holds rows
[c Kp/C, (c+1) Kp/C) (`flat_client_sharding`). A round is the
reference's schedule, each `jax.lax.psum` an `all_reduce` over the axes
it names:

  per rank:    g = all_reduce_data(weighted_agg(psi[mine], x_mine))   (1)
               (dots, sqs) of the rank's rows scattered into a zero
               (2, Kp) block, all_reduced; ||g||^2 from the same g     (2)
  replicated:  theta -> Eq. 9 -> Gompertz softmax weights w          (3)
  per rank:    delta = all_reduce_data(weighted_agg(w[mine], x_mine)) (4)

On a client-only mesh (`make_round_ops`) x_mine is the rank's
(Kp/C, N) rows: two (N,) f32 all-reduces and one (2, Kp) a round
(fedavg / fedprox reuse g: one N-wide all-reduce). On a 2D (client x
model) mesh (`make_round_ops_2d`) it is the rank's (K_loc, N_loc) tile
of the blocked layout (`treemath.blocked_layout`): each rank ravels its
LOCAL leaf blocks (a model-sharded leaf's block, a replicated leaf's
ceil-split column slice) and quantizes them shard-locally, the 2D wire
(a scale never straddles a model-axis split). Steps (1) and (4) then
all-reduce N_loc floats over "data" only, (2)'s (2, Kp) block goes over
both axes and ||g||^2 over "model", and the outputs are the rank's
local blocks, each leaf of its `NamedSpec(mesh, spec).shard_shape`: a
replicated leaf is re-joined by one all_gather of its column slices
over "model", a model-sharded leaf is never gathered in the region.
Every step streams the tile through the port's CUDA kernels,
dequantizing the int8 / int4 wire in registers; a scale never crosses
ranks. After each call every rank holds the same bits.

`make_round_ops` and `make_round_ops_2d` are the sync round's regions
(`core.fl`'s engine="flat_sharded"), `make_blocked_roundtrip` the tree
engine's 2D wire, `make_buffered_flush_ops` the buffered flush's (on a
2D mesh over column tiles of the report buffer), and `fedadp_aggregate`
the standalone per-leaf ("tree") and flat API. `local_blocks` cuts a
rank's model blocks from whole leaves and `gather_model_sharded`
re-joins them. A round given `param_specs` (`core.fl.make_round_fn`)
trains tensor-parallel and hands the region its delta blocks as they
are, so neither runs on its path; without them the ranks train whole
models, and `core.fl` cuts the blocks before the region and gathers the
sharded leaves after it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import transport as transport_mod
from repro_torch.core import treemath, weighting
from repro_torch.kernels import round_stats as round_stats_mod
from repro_torch.kernels import weighted_agg as weighted_agg_mod

Tree = Any

MODEL_AXIS = "model"
CLIENT_AXES = ("data",)
BOTH_AXES = ("data", MODEL_AXIS)


def model_axis_size(mesh) -> int:
    """Size of the mesh's "model" axis (1 when absent): > 1 selects the
    2D (client x model) layout."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(MODEL_AXIS, 1))


def client_axis_size(mesh) -> int:
    return int(mesh.shape["data"])


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
    """Row sharding of the (Kp, N) flat delta buffer over the client
    axis: this rank's block (the ranks of one model group share it)."""
    return RowShard(mesh.client_index, mesh.client_size)


def padded_k(k: int, size: int) -> int:
    """K rounded up to a multiple of `size`, the mesh's (the reference's
    `-(-k // csize) * csize`)."""
    return -(-k // size) * size


def replicate_rows(mesh, local: torch.Tensor, k: int) -> torch.Tensor:
    """The (k, ...) rows of a client axis on every rank, from each rank's
    `local` rows: its block of the axis padded to `padded_k`, cut at k
    (a rank past k holds none). One broadcast over the mesh from the
    rank at model index 0 of each client index that owns rows, so every
    bit (a -0.0 too) arrives as that owner computed it."""
    csize, msize = client_axis_size(mesh), model_axis_size(mesh)
    k_loc = padded_k(k, csize) // csize
    out = torch.empty((k,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    for c in range(csize):
        part = out[c * k_loc:min((c + 1) * k_loc, k)]
        if part.shape[0] == 0:
            continue
        src = c * msize
        if src == mesh.rank:
            part.copy_(local)
        mesh.broadcast(part, src, axes=BOTH_AXES)
    return out


def _shard_slots(values: torch.Tensor, mesh) -> slice:
    """The global client slots of this rank's rows (the reference returns
    them as an index vector; a slice views them in place)."""
    return flat_client_sharding(mesh).rows(
        values.shape[0] * client_axis_size(mesh))


def _model_dim(spec) -> int:
    """The dim a leaf's spec puts on the model axis, or -1."""
    spec = tuple(spec or ())
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else -1


def local_blocks(mesh, stacked_rows: Tree, pspecs: Tree) -> Tree:
    """This rank's blocks of its client rows: each leaf of `stacked_rows`
    ((k_loc, *shape)) cut on the dim its unstacked spec in `pspecs` puts
    on the model axis to the block at the rank's model index, so it has
    `NamedSpec(mesh, ("data",) + spec).shard_shape`; a replicated leaf
    whole. Views, no collective."""
    msize, j = model_axis_size(mesh), mesh.model_index
    leaves, treedef = treemath.tree_flatten(stacked_rows)
    out = []
    for x, spec in zip(leaves, treemath.tree_leaves_like(stacked_rows,
                                                         pspecs)):
        d = _model_dim(spec)
        if d >= 0:
            step = x.shape[d + 1] // msize
            x = x.narrow(d + 1, j * step, step)
        out.append(x)
    return treemath.tree_unflatten(treedef, out)


def gather_model_sharded(mesh, trees: list, pspecs: Tree) -> list:
    """Whole leaves on every rank from the rank's local blocks (`trees`,
    f32 trees as `make_round_ops_2d` returns them): one all_gather over
    "model" of every model-sharded leaf's block of every tree, joined on
    its sharded dim; replicated leaves as they are. Not part of any
    region: it runs after the region of a round whose ranks hold whole
    models; a round given `param_specs` never runs it."""
    msize = model_axis_size(mesh)
    flat = [treemath.tree_flatten(t) for t in trees]
    dims = [_model_dim(s)
            for s in treemath.tree_leaves_like(trees[0], pspecs)]
    blocks = [x for leaves, _ in flat
              for x, d in zip(leaves, dims) if d >= 0]
    if msize == 1 or not blocks:
        return list(trees)
    joined = mesh.all_gather(torch.cat([x.reshape(-1) for x in blocks]),
                             axes=(MODEL_AXIS,)).reshape(msize, -1)
    out, off = [], 0
    for leaves, treedef in flat:
        new = []
        for x, d in zip(leaves, dims):
            if d >= 0:
                n = x.numel()
                x = torch.cat([joined[j, off:off + n].reshape(x.shape)
                               for j in range(msize)], dim=d)
                off += n
            new.append(x)
        out.append(treemath.tree_unflatten(treedef, new))
    return out


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


def _all_stats(mesh, mine: slice, kp: int, d_loc, s_loc,
               axes=CLIENT_AXES):
    """(dots, sqs), (Kp,) each on every rank: the rank's values at its
    slots of a zero (2, Kp) block, all_reduced once over `axes` (both
    on a 2D mesh, where each rank holds a part of every row)."""
    both = torch.zeros((2, kp), dtype=torch.float32, device=d_loc.device)
    both[0, mine] = d_loc
    both[1, mine] = s_loc
    mesh.all_reduce(both, axes=axes)
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


def _blocked_unstack_local(vec: torch.Tensor, layout, *, dtypes=None,
                           mesh) -> list:
    """Per-leaf outputs from a blocked (..., width) tensor: a model-sharded
    leaf's segment is its local block (a reshape: the leaf stays
    sharded); the replicated leaves' column slices are re-joined by ONE
    all_gather over "model" of all of them (O(replicated size), never a
    model-sharded leaf)."""
    m = layout.n_shards
    segs = treemath.blocked_split(vec, layout)
    lead = tuple(vec.shape[:-1])
    rep = [i for i, d in enumerate(layout.sharded_dims) if d < 0]
    if rep:
        part = torch.cat([segs[i] for i in rep], dim=-1)
        joined = mesh.all_gather(part, axes=(MODEL_AXIS,), dim=-1).reshape(
            lead + (m, part.shape[-1]))
    out, off = [], 0
    for i, (seg, shape, sdim) in enumerate(
            zip(segs, layout.shapes, layout.sharded_dims)):
        dt = layout.dtypes[i] if dtypes is None else dtypes
        if sdim >= 0:
            local = list(shape)
            local[sdim] //= m
            out.append(seg.reshape(lead + tuple(local)).to(dt))
        else:
            w = layout.widths[i]
            full = joined[..., off:off + w].reshape(lead + (m * w,))
            off += w
            out.append(full[..., :math.prod(shape)].reshape(lead + shape)
                       .to(dt))
    return out


def make_round_ops_2d(mesh, template_stacked: Tree, pspecs: Tree, *,
                      alpha: float, method: str = "fedadp",
                      transport: str = "f32", group_size: int = 0,
                      keep=None):
    """`make_round_ops` on a 2D (client x model) mesh, tree in, tree out.

    The flat buffer becomes a ("data", "model") grid of (K_loc, N_loc)
    tiles: each rank ravels its local stacked leaf blocks
    (`treemath.blocked_ravel_local`: a model-sharded leaf's block, a
    replicated leaf's column slice, so no leaf is gathered to full
    width), quantizes the tile shard-locally (transport != "f32": the
    int8 / int4 scale chunks never straddle a model-axis split, THE wire
    of a 2D mesh), and streams it through the kernels. The partial dots
    and squared norms are summed over both axes, ||g||^2 over "model"
    (g is already summed over the clients), the Eq. 9 and Gompertz
    weights are replicated scalar math, and the two aggregates are
    summed over "data" ONLY: their columns stay model-sharded.

    `template_stacked`: a K-stacked delta tree of the global shapes (its
    client axis padded to the client-axis size; meta tensors do) and
    `pspecs` the UNSTACKED spec tree (`models.sharding.param_pspecs`);
    `keep` one angle-filter flag a leaf (None: all), baked into the
    tile's (N_loc,) mask.

    Returns round_op(deltas, psi, smoothed_sel, count_sel, data_sizes) ->
    (g_tree, dots, sqs, sqg, delta_tree, theta, theta_sm, w): `deltas` is
    this rank's local blocks of its client rows (`local_blocks`: each
    leaf (K_loc, *shard_shape)), the rest replicated (Kp,) vectors as in
    `make_round_ops`. g_tree and delta_tree are UNSTACKED f32 trees of
    the rank's local blocks (`NamedSpec(mesh, spec).shard_shape` a
    leaf); the six others are the same on every rank."""
    msize = model_axis_size(mesh)
    if msize <= 1:
        raise ValueError(
            "make_round_ops_2d needs a mesh with a 'model' axis of size "
            "> 1; use make_round_ops for client-only sharding")
    layout = treemath.blocked_layout(template_stacked, pspecs, msize,
                                     MODEL_AXIS)
    if transport == "int4":
        group_size = group_size or transport_mod.GROUP_SIZE
        transport_mod.validate_group_size(group_size)
    mask = treemath.blocked_segment_mask(layout, keep).to(mesh.device)
    n_loc = layout.width
    kw = dict(transport=transport, group_size=group_size)
    treedef = treemath.tree_flatten(template_stacked)[1]
    local_shapes = [tuple(s // msize if d == sdim else s
                          for d, s in enumerate(shape))
                    for shape, sdim in zip(layout.shapes,
                                           layout.sharded_dims)]

    def round_op(deltas, psi, smoothed_sel, count_sel, data_sizes):
        leaves = treemath.tree_leaves(deltas)
        got = [tuple(x.shape[1:]) for x in leaves]
        if got != local_shapes:
            raise ValueError(f"round_op takes the rank's local blocks "
                             f"{local_shapes}, got {got}")
        with mesh.scope("round_ops_2d"):
            x = treemath.blocked_ravel_local(leaves, layout,
                                             mesh.model_index)
            q = transport_mod.quantize(
                x, transport,
                group_size=group_size or transport_mod.GROUP_SIZE)
            values, scales = q.values, q.scales
            mine = _shard_slots(x, mesh)
            g_loc = mesh.all_reduce(
                _shard_agg(psi[mine], values, scales, n=n_loc, **kw))
            d_loc, s_loc, sqg_loc = _shard_stats(values, scales, g_loc,
                                                 mask, **kw)
            dots, sqs = _all_stats(mesh, mine, psi.shape[0], d_loc, s_loc,
                                   axes=BOTH_AXES)
            sqg = mesh.all_reduce(sqg_loc.reshape(1),
                                  axes=(MODEL_AXIS,)).reshape(())
            theta = weighting.instantaneous_angle(dots, sqs, sqg)
            theta_sm = _smooth(theta, smoothed_sel, count_sel)
            if method == "fedadp":
                w = weighting.fedadp_weights(theta_sm, data_sizes, alpha)
                delta_loc = mesh.all_reduce(
                    _shard_agg(w[mine], values, scales, n=n_loc, **kw))
            else:  # w == psi: the statistics' aggregate is the delta
                w = psi
                delta_loc = g_loc
            g_tree, delta_tree = (
                treemath.tree_unflatten(treedef, _blocked_unstack_local(
                    v, layout, dtypes=torch.float32, mesh=mesh))
                for v in (g_loc, delta_loc))
        return g_tree, dots, sqs, sqg, delta_tree, theta, theta_sm, w

    return round_op


def make_blocked_roundtrip(mesh, template_stacked: Tree, pspecs: Tree, *,
                           transport: str, group_size: int = 0,
                           local: bool = False):
    """The shard-local wire roundtrip of the TREE engine on a 2D mesh.

    On a (client x model) mesh the uplink is quantized per (client,
    model shard) block, scale chunks shard-local (`make_round_ops_2d`).
    The tree engine must read the SAME reconstruction. Each row's chunks
    depend only on its own model block, so every rank, holding every
    client's whole delta, computes all the mesh's blocks locally: each
    block j of the blocked layout is raveled, quantized and dequantized
    (every row at once: the wire's chunks are per row), and the leaves
    are re-joined from their blocks, with no collective. The result is
    the reference's blocked roundtrip bit for bit; the tree engine then
    runs its per-leaf reductions on it (it never reads the wire).

    Returns roundtrip(deltas_stacked) -> the stacked f32 tree, shaped
    like its input (the whole stacked tree, the same on every rank).

    With `local` the input is this rank's blocks (a model-sharded leaf's
    block, a replicated leaf whole: the tensor-parallel round's deltas,
    `template_stacked` still of the global shapes): the rank quantizes
    its own block only and re-joins the replicated leaves' column slices
    with one all_gather over "model" (their size, never a sharded
    leaf's), as `make_round_ops_2d` does."""
    msize = model_axis_size(mesh)
    layout = treemath.blocked_layout(template_stacked, pspecs, msize,
                                     MODEL_AXIS)
    if transport == "int4":
        group_size = group_size or transport_mod.GROUP_SIZE
        transport_mod.validate_group_size(group_size)
    gs = group_size or transport_mod.GROUP_SIZE

    def roundtrip_local(deltas):
        leaves, treedef = treemath.tree_flatten(deltas)
        block = treemath.blocked_ravel_local(leaves, layout, mesh.model_index)
        return treemath.tree_unflatten(treedef, _blocked_unstack_local(
            transport_mod.dequantize(transport_mod.quantize(
                block, transport, group_size=gs)),
            layout, dtypes=torch.float32, mesh=mesh))

    def roundtrip(deltas):
        leaves, treedef = treemath.tree_flatten(deltas)
        k = leaves[0].shape[0]
        segs = []  # segs[j][i]: leaf i's segment of block j, (K, w_i)
        for j in range(msize):
            local = [x if d < 0 else x.narrow(
                d + 1, j * (x.shape[d + 1] // msize), x.shape[d + 1] // msize)
                for x, d in zip(leaves, layout.sharded_dims)]
            block = treemath.blocked_ravel_local(local, layout, j)
            segs.append(treemath.blocked_split(transport_mod.dequantize(
                transport_mod.quantize(block, transport, group_size=gs)),
                layout))
        out = []
        for i, (shape, sdim) in enumerate(zip(layout.shapes,
                                              layout.sharded_dims)):
            parts = [seg[i] for seg in segs]
            if sdim >= 0:
                local = list(shape)
                local[sdim] //= msize
                out.append(torch.cat([p.reshape((k,) + tuple(local))
                                      for p in parts], dim=sdim + 1))
            else:
                out.append(torch.cat(parts, dim=1)[:, :math.prod(shape)]
                           .reshape((k,) + shape))
        return treemath.tree_unflatten(treedef, out)

    return roundtrip_local if local else roundtrip


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
    `values` is this rank's (Kp/C, N) block of the buffer, the rest is
    replicated, as in `make_round_ops`.

    On a 2D (client x model) mesh the buffer's COLUMNS shard too: the
    report buffer stays the global f32 (K, N) array (admission does not
    change), N is zero-padded to Np, a multiple of the model axis's size
    M (`core.fl` pads and slices the outputs back), and `values` / `mask`
    are the rank's (Kp/C, Np/M) tile / (Np/M,) slice. The dots and
    squared norms are summed over both axes, ||g||^2 over "model", the
    aggregates over "data" only: g_flat and delta_flat are the rank's
    (Np/M,) column slices."""
    msize = model_axis_size(mesh)
    stat_axes = BOTH_AXES if msize > 1 else CLIENT_AXES

    def _body(values, psi, mask, smoothed_sel, count_sel, sizes, age,
              landed):
        mine = _shard_slots(values, mesh)
        g_flat = mesh.all_reduce(weighted_agg_mod.weighted_agg(
            psi[mine], values, out_dtype=torch.float32))
        d_loc, s_loc, sqg = round_stats_mod.round_stats(values, g_flat,
                                                        mask)
        dots, sqs = _all_stats(mesh, mine, psi.shape[0], d_loc, s_loc,
                               axes=stat_axes)
        if msize > 1:
            sqg = mesh.all_reduce(sqg.reshape(1),
                                  axes=(MODEL_AXIS,)).reshape(())
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
    rank's rows (summed over "data"; the ranks of a model group hold
    whole leaves and compute alike); engine="flat" ravels them into a
    (K/C, N) row block and runs `make_round_ops` (client-only specs;
    `transport` compresses the block to the wire first), or on a 2D
    mesh ravels the rank's blocks and runs `make_round_ops_2d`
    (`_fedadp_aggregate_flat_2d`). K must divide over the client axis.

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
    if model_axis_size(mesh) > 1:
        return _fedadp_aggregate_flat_2d(
            mesh, delta_pspecs, alpha=alpha, method=method,
            transport=transport, group_size=group_size)
    for s in _spec_leaves(delta_pspecs):
        if any(e is not None for e in tuple(s or ())[1:]):
            raise ValueError(
                "engine='flat' ravels each client's delta into one "
                f"contiguous row and requires client-only sharding; got {s}"
                " (add a 'model' mesh axis for the 2D flat engine, or use "
                "engine='tree' for model-axis-sharded leaves)")
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


def _unstacked_specs(delta_pspecs: Tree) -> Tree:
    """The stacked spec tree without its client entry: the param specs."""
    if isinstance(delta_pspecs, dict):
        return {k: _unstacked_specs(v) for k, v in delta_pspecs.items()}
    return tuple(delta_pspecs or ())[1:]


def _fedadp_aggregate_flat_2d(mesh, delta_pspecs: Tree, *, alpha: float,
                              method: str, transport: str,
                              group_size: int):
    """`fedadp_aggregate(engine="flat")` on a (client x model) mesh: the
    rank's blocks of its rows through `make_round_ops_2d`; the weighted
    delta's model-sharded leaves are gathered after the region, so it is
    whole and the same on every rank."""
    pspecs = _unstacked_specs(delta_pspecs)

    def body(deltas, data_sizes, smoothed_prev, count_prev):
        k = data_sizes.shape[0]
        csize = client_axis_size(mesh)
        if k % csize:
            raise ValueError(
                f"engine='flat' needs K divisible by the client-axis size "
                f"(K={k}, client axis {csize}); pad the cohort or use "
                "engine='tree'")
        round_op = make_round_ops_2d(
            mesh, deltas, pspecs, alpha=alpha, method=method,
            transport=transport, group_size=group_size)
        rows = flat_client_sharding(mesh).rows(k)
        local = local_blocks(
            mesh, treemath.tree_map(lambda x: x[rows], deltas), pspecs)
        psi_avg = weighting.fedavg_weights(data_sizes)
        _, _, _, _, delta_tree, theta, theta_sm, w = round_op(
            local, psi_avg, smoothed_prev, count_prev, data_sizes)
        delta_tree, = gather_model_sharded(mesh, [delta_tree], pspecs)
        return delta_tree, theta, theta_sm, w

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


def column_tile(mesh, rows: torch.Tensor, mask=None) -> tuple:
    """The rank's column tile of `rows` ((k, N)) and of the (N,) `mask`
    (None stays None) on the model axis: N zero-padded to Np, a multiple
    of its size M, the tile columns [j Np/M, (j+1) Np/M) at the rank's
    model index j; one contiguous copy (the kernels take dense rows)."""
    n = rows.shape[1]
    width = padded_k(n, model_axis_size(mesh)) // model_axis_size(mesh)
    lo = min(mesh.model_index * width, n)
    cols = slice(lo, min(lo + width, n))
    tile = rows.new_zeros((rows.shape[0], width))
    tile[:, :cols.stop - cols.start] = rows[:, cols]
    if mask is not None:
        mask = torch.nn.functional.pad(mask[cols],
                                       (0, width - (cols.stop - cols.start)))
    return tile, mask


def local_block(a: torch.Tensor, kp: int, shard: RowShard,
                fill=0) -> torch.Tensor:
    """`shard`'s block of `a` (K rows) padded to `kp` rows with `fill`,
    without building the whole padded array (a view of `a` when no row
    of the block is padding)."""
    mine = shard.rows(kp)
    k = a.shape[0]
    return pad_rows(a[min(mine.start, k):min(mine.stop, k)],
                    mine.stop - mine.start, fill)
