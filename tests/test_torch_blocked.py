"""The port's treemath against the JAX package's, in this process: the
five reference helpers (`tree_dot`, `tree_dot_and_norms`,
`tree_zeros_like`, `tree_cast`, `global_norm`) at the cases of
tests/test_treemath.py:24, :29 and :111, and the 2D (client x model)
blocked layout (`BlockedLayout`, `blocked_layout`, `blocked_ravel_local`,
`blocked_split`, `blocked_segment_mask`) with the blocked wire at the
cases of tests/test_transport.py:744-860.

Held: the reductions at the reference test's rtol 1e-5 (against the JAX
functions and the float64 sums); the layout's fields equal; the blocked
ravel, split and mask, and each block's wire (int8 and int4 values and
scales) and its reconstruction, equal to the JAX functions' bit for bit
(the wire contract: a model block is quantized on its own); and
`fl_shard_map.make_blocked_roundtrip` equal, bit for bit, to the JAX
functions' block-by-block replay (tests/test_transport.py:800) on
(2, 4) and (4, 2) meshes. The same roundtrip on real meshes is held in
tests/test_torch_mesh2d.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import transport as jtq
from repro.core import treemath as jtm
from repro_torch import transport as tq
from repro_torch.core import fl_shard_map as tsm
from repro_torch.core import treemath as ttm
from repro_torch.launch.mesh import AbstractMesh

TOL = 1e-5


def _rand_tree(seed):
    """tests/test_treemath.py's tree: a dict holding a list."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(37, 11)).astype(np.float32),
            "y": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 3, 4)).astype(np.float32)]}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _np_flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree.leaves(tree)])


# ----------------------------------------------- the five reference helpers


def test_dot_and_norms():
    """tests/test_treemath.py:24: against float64 and the JAX functions."""
    a, b = _rand_tree(0), _rand_tree(1)
    fa, fb = _np_flat(a), _np_flat(b)
    got = ttm.tree_dot_and_norms(_t(a), _t(b))
    want = jtm.tree_dot_and_norms(_jax(a), _jax(b))
    for g, w, exact in zip(got, want, (fa @ fb, fa @ fa, fb @ fb)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), exact, rtol=TOL)
        np.testing.assert_allclose(float(g), float(w), rtol=TOL)
    dot = ttm.tree_dot(_t(a), _t(b))
    np.testing.assert_allclose(float(dot), fa @ fb, rtol=TOL)
    np.testing.assert_allclose(float(dot),
                               float(jtm.tree_dot(_jax(a), _jax(b))),
                               rtol=TOL)


def test_ravel_consistent_with_tree_reductions():
    """tests/test_treemath.py:111."""
    a, b = _t(_rand_tree(0)), _t(_rand_tree(1))
    va, _ = ttm.tree_ravel(a)
    vb, _ = ttm.tree_ravel(b)
    np.testing.assert_allclose(float(va @ vb), float(ttm.tree_dot(a, b)),
                               rtol=TOL)
    np.testing.assert_allclose(float(va @ va), float(ttm.tree_sqnorm(a)),
                               rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_zeros_like_and_cast(dtype):
    """tests/test_treemath.py:29's tree: global_norm in f32 whatever the
    leaf dtype, zeros of each leaf's shape and dtype, and a cast of every
    leaf, as the JAX functions give them."""
    tree = _rand_tree(3)
    jt = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    tt = ttm.tree_map(lambda a: a.to(getattr(torch, dtype)), _t(tree))
    norm = ttm.global_norm(tt)
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), float(jtm.global_norm(jt)),
                               rtol=TOL)
    np.testing.assert_allclose(float(norm) ** 2, float(ttm.tree_sqnorm(tt)),
                               rtol=TOL)
    zeros = ttm.tree_zeros_like(tt)
    jzeros = jtm.tree_zeros_like(jt)
    for z, jz, x in zip(ttm.tree_leaves(zeros), jax.tree.leaves(jzeros),
                        ttm.tree_leaves(tt)):
        assert z.shape == x.shape == tuple(jz.shape) and z.dtype == x.dtype
        assert not torch.any(z)
    for target in ("float32", "bfloat16"):
        cast = ttm.tree_cast(tt, getattr(torch, target))
        jcast = jtm.tree_cast(jt, getattr(jnp, target))
        assert ttm.tree_flatten(cast)[1] == ttm.tree_flatten(tt)[1]
        for c, jc in zip(ttm.tree_leaves(cast), jax.tree.leaves(jcast)):
            assert c.dtype == getattr(torch, target)
            np.testing.assert_array_equal(c.float().numpy(),
                                          np.asarray(jc, np.float32))


# ---------------------------------------------------- the blocked layout

# tests/test_transport.py:744's fixture, and a stacked LM-like tree whose
# leaves shard on the first, middle and last dims and one that does not
FIXTURES = {
    "wire": (dict(wq=(6, 8), b=(7,)),
             dict(wq=(None, "model"), b=(None,))),
    "lm": (dict(embed=(16, 6), blocks=dict(wq=(2, 6, 8), w_down=(2, 8, 6),
                                           scale=(2, 6)), final=(6,),
                scalar=()),
           dict(embed=("model", None),
                blocks=dict(wq=(None, None, "model"),
                            w_down=(None, "model", None),
                            scale=(None, None)),
                final=(None,), scalar=())),
}
KEEP = {"wire": [False, True], "lm": [True, True, False, True, True, False]}


def _stacked(name, k=3, seed=0):
    rng = np.random.default_rng(seed)
    shapes, _ = FIXTURES[name]

    def make(s):
        if isinstance(s, dict):
            return {key: make(v) for key, v in s.items()}
        return rng.normal(size=(k,) + s).astype(np.float32)

    return make(shapes)


def _jspecs(specs):
    if isinstance(specs, dict):
        return {k: _jspecs(v) for k, v in specs.items()}
    return P(*specs)


def _local(leaves, layout, j, m):
    """Shard j's stacked local blocks of numpy leaves (the reference
    test's `block`)."""
    out = []
    for x, sdim in zip(leaves, layout.sharded_dims):
        if sdim >= 0:
            step = x.shape[sdim + 1] // m
            sl = [slice(None)] * x.ndim
            sl[sdim + 1] = slice(j * step, (j + 1) * step)
            x = x[tuple(sl)]
        out.append(np.ascontiguousarray(x))
    return out


def _both(name, m):
    stacked = _stacked(name)
    jl = jtm.blocked_layout(_jax(stacked), _jspecs(FIXTURES[name][1]), m)
    tl = ttm.blocked_layout(_t(stacked), FIXTURES[name][1], m)
    return stacked, jl, tl


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("m", [1, 2, 4])
def test_blocked_layout_matches_jax(name, m):
    _, jl, tl = _both(name, m)
    assert isinstance(tl, ttm.BlockedLayout)
    assert tl._fields == jl._fields
    for field in ("n_shards", "width", "n_logical", "shapes",
                  "sharded_dims", "widths"):
        assert getattr(tl, field) == getattr(jl, field), field
    assert [str(d).split(".")[-1] for d in tl.dtypes] == \
        [str(d) for d in jl.dtypes]


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("m", [2, 4])
def test_blocked_ravel_split_and_mask_match_jax(name, m):
    stacked, jl, tl = _both(name, m)
    leaves = jax.tree.leaves(stacked)
    for j in range(m):
        loc = _local(leaves, jl, j, m)
        jb = np.asarray(jtm.blocked_ravel_local([jnp.asarray(x) for x in loc],
                                                jl, j))
        tb = ttm.blocked_ravel_local([torch.from_numpy(x) for x in loc], tl, j)
        assert tb.is_contiguous() and tb.dtype == torch.float32
        np.testing.assert_array_equal(tb.numpy(), jb)
        for a, b in zip(ttm.blocked_split(tb, tl),
                        jtm.blocked_split(jnp.asarray(jb), jl)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for keep in (None, KEEP[name]):
        np.testing.assert_array_equal(
            ttm.blocked_segment_mask(tl, keep).numpy(),
            np.asarray(jtm.blocked_segment_mask(jl, keep)))


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("wire,gs", [("int8", 0), ("int4", 8), ("int4", 4)])
def test_block_wire_bytes_match_jax(name, wire, gs):
    """Each model block's wire, quantized on its own: values, scales and
    the reconstruction equal the JAX quantizer's bit for bit."""
    m = 2
    stacked, jl, tl = _both(name, m)
    kw = dict(group_size=gs) if gs else {}
    for j in range(m):
        loc = _local(jax.tree.leaves(stacked), jl, j, m)
        jb = jtm.blocked_ravel_local([jnp.asarray(x) for x in loc], jl, j)
        tb = ttm.blocked_ravel_local([torch.from_numpy(x) for x in loc], tl, j)
        jq, tqz = jtq.quantize(jb, wire, **kw), tq.quantize(tb, wire, **kw)
        np.testing.assert_array_equal(tqz.values.numpy(),
                                      np.asarray(jq.values))
        np.testing.assert_array_equal(tqz.scales.numpy().view(np.uint32),
                                      np.asarray(jq.scales).view(np.uint32))
        np.testing.assert_array_equal(
            tq.dequantize(tqz).numpy().view(np.uint32),
            np.asarray(jtq.dequantize(jq)).view(np.uint32))


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("wire,gs", [("int8", 0), ("int4", 8)])
def test_blocked_roundtrip_matches_jax_replay(name, shape, wire, gs):
    """`make_blocked_roundtrip` (no collective: every rank holds every
    client) == the JAX functions replayed block by block, the leaves
    re-joined from their blocks: bit for bit."""
    m = shape[1]
    stacked, jl, _ = _both(name, m)
    leaves = jax.tree.leaves(stacked)
    kw = dict(group_size=gs) if gs else {}
    recon = [jtm.blocked_split(jtq.roundtrip(jtm.blocked_ravel_local(
        [jnp.asarray(x) for x in _local(leaves, jl, j, m)], jl, j), wire,
        **kw), jl) for j in range(m)]
    k = leaves[0].shape[0]
    want = []
    for i, (shp, sdim) in enumerate(zip(jl.shapes, jl.sharded_dims)):
        parts = [np.asarray(r[i]) for r in recon]
        if sdim >= 0:
            local = list(shp)
            local[sdim] //= m
            want.append(np.concatenate(
                [p.reshape((k,) + tuple(local)) for p in parts],
                axis=sdim + 1))
        else:
            size = int(np.prod(shp))
            want.append(np.concatenate(parts, axis=1)[:, :size]
                        .reshape((k,) + shp))
    mesh = AbstractMesh(shape, ("data", "model"))
    rt = tsm.make_blocked_roundtrip(mesh, _t(stacked), FIXTURES[name][1],
                                    transport=wire, group_size=gs)
    got = ttm.tree_leaves(rt(_t(stacked)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.view(np.uint32))


def test_blocked_layout_refusals_are_the_references():
    """A dim that does not divide, an entry mixing the model axis with
    another, the model axis twice: the reference's ValueErrors."""
    x = {"w": torch.zeros(3, 6, 5)}
    cases = [((None, "model"), "not divisible by 2"),
             ((("data", "model"), None), "mixes 'model' with other axes"),
             (("model", "model"), "shards 'model' twice")]
    for spec, msg in cases:
        with pytest.raises(ValueError, match=msg):
            ttm.blocked_layout(x, {"w": spec}, 2)
        with pytest.raises(ValueError, match=msg):
            jtm.blocked_layout({"w": jnp.zeros((3, 6, 5))},
                               {"w": P(*spec)}, 2)


def test_local_blocks_cut_the_rank_block():
    """`local_blocks` cuts each model-sharded leaf to the rank's block (a
    view) and leaves a replicated one whole; the blocks of every model
    index, joined on the sharded dim, are the leaf."""
    stacked = _t(_stacked("lm"))
    specs = FIXTURES["lm"][1]

    class Rank:
        def __init__(self, j):
            self.model_index, self.shape = j, {"data": 1, "model": 2}

    blocks = [tsm.local_blocks(Rank(j), stacked, specs) for j in range(2)]
    for path, whole, b0, b1, spec in zip(
            ttm.tree_paths(stacked), ttm.tree_leaves(stacked),
            ttm.tree_leaves(blocks[0]), ttm.tree_leaves(blocks[1]),
            ttm.tree_leaves_like(stacked, specs)):
        d = tsm._model_dim(spec)
        if d < 0:
            assert b0 is whole and b1 is whole, path
        else:
            assert b0.data_ptr() == whole.data_ptr(), path
            assert torch.equal(torch.cat([b0, b1], dim=d + 1), whole), path
