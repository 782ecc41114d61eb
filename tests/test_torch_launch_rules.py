"""The launch layer's shapes and partition rules against the JAX package
(`configs/shapes.py`, `models/sharding.py`, the rules of
`launch/steps.py`), on the full-size trees of all ten architectures.

(a) `SHAPES`, `config_for_shape` and `fl_mode_for` for every arch (the
    port's `param_count` counts the port's own params).
(b) `param_pspecs` (fsdp on and off, with and without the MQA k/v
    `replicate_extra` of `_replicate_extra`), `shard_batch_dim`,
    `_cache_shardings` and `_pos_shard` against the JAX functions on a
    `jax.sharding.AbstractMesh` of shape (1, 1), (16, 16), (2, 16, 16),
    (32, 8) and (2, 32, 8), over the param tree, every shape's batch
    (at the train step's per-client B and the serving B) and every
    decode shape's cache; a JAX `PartitionSpec` compares as a tuple.
(c) Every leaf's `NamedSpec.shard_shape` against
    `NamedSharding(...).shard_shape`.
(d) `token_batch_specs`, `cache_specs` and `decode_specs`: shapes and
    dtypes against the JAX package's `eval_shape`, every arch and shape.
    Tokens and positions are int32 in both.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import sharding as jsharding
from repro_torch.configs import registry
from repro_torch.configs import shapes
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh as TorchMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding

ARCHS = sorted(registry.ARCHS)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "32x8": ((32, 8), ("data", "model")),
          "2x32x8": ((2, 32, 8), ("pod", "data", "model"))}
_JPARAMS: dict = {}
_TPARAMS: dict = {}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), TorchMesh(sizes, names)


def _jparams(arch):
    if arch not in _JPARAMS:
        _JPARAMS[arch] = jsteps.params_sds(jregistry.get(arch))
    return _JPARAMS[arch]


def _tparams(arch):
    if arch not in _TPARAMS:
        _TPARAMS[arch] = steps.params_sds(registry.get(arch))
    return _TPARAMS[arch]


def _jdtype(dt: torch.dtype):
    return jnp.dtype(str(dt).replace("torch.", ""))


def _jleaves(tree):
    """[(keys, leaf)] of a JAX tree, keys as the reference names them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))
    return [(tuple(getattr(k, "key", getattr(k, "name", "")) for k in p), x)
            for p, x in flat]


def _tleaves(tree):
    """[(keys, leaf)] of a port tree whose leaves may be spec tuples."""
    out = []

    def walk(t, keys):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], keys + (k,))
        else:
            out.append((keys, t))

    walk(tree, ())
    return out


def _specs_equal(jtree, ttree, shapes_tree=None):
    """JAX specs (P or NamedSharding) == port specs (tuple or NamedSpec),
    leaf for leaf by key path; with `shapes_tree` (port meta tensors)
    also every leaf's shard_shape."""
    jl, tl = _jleaves(jtree), _tleaves(ttree)
    assert [k for k, _ in jl] == [k for k, _ in tl]
    shp = dict(_tleaves(shapes_tree)) if shapes_tree is not None else {}
    for (keys, j), (_, t) in zip(jl, tl):
        jspec = j.spec if isinstance(j, NamedSharding) else j
        tspec = t.spec if isinstance(t, sharding.NamedSpec) else t
        assert tuple(jspec) == tspec, (keys, jspec, tspec)
        if keys in shp:
            shape = tuple(shp[keys].shape)
            assert j.shard_shape(shape) == t.shard_shape(shape), keys


# -------------------------------------------------------- (a) the tables


def test_shapes_table_is_the_references():
    assert set(shapes.SHAPES) == set(jshapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        j = jshapes.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW
    assert steps.SEQUENTIAL_THRESHOLD == jsteps.SEQUENTIAL_THRESHOLD


@pytest.mark.parametrize("arch", ARCHS)
def test_config_for_shape_and_fl_mode(arch):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    assert shapes.needs_swa_for_long(cfg) == jshapes.needs_swa_for_long(jcfg)
    for name in shapes.SHAPES:
        got = shapes.config_for_shape(cfg, shapes.SHAPES[name])
        want = jshapes.config_for_shape(jcfg, jshapes.SHAPES[name])
        assert got.sliding_window == want.sliding_window, name
    assert steps.fl_mode_for(cfg) == jsteps.fl_mode_for(jcfg)


# -------------------------------------------------------- (b, c) the rules


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shard_shapes(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    jp, tp = _jparams(arch), _tparams(arch)
    rep = steps._replicate_extra(cfg, tmesh, True)
    assert rep == jsteps._replicate_extra(jcfg, jmesh, True)
    for fsdp in (False, True):
        for extra in (frozenset(), rep):
            _specs_equal(
                jsharding.param_shardings(jp, jmesh, fsdp=fsdp,
                                          replicate_extra=extra),
                sharding.param_shardings(tp, tmesh, fsdp=fsdp,
                                         replicate_extra=extra), tp)
            _specs_equal(
                jsharding.param_pspecs(jp, jmesh, fsdp=fsdp,
                                       replicate_extra=extra),
                sharding.param_pspecs(tp, tmesh, fsdp=fsdp,
                                      replicate_extra=extra))


def _batches(cfg, mesh):
    """Every shape's batch specs at the train step's per-client B and at
    the serving global B."""
    out = []
    total = sharding.batch_total(mesh)
    for s in shapes.SHAPES.values():
        for b in {max(s.global_batch // total, 1), s.global_batch}:
            out.append((b, s.seq_len))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_position_specs(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    for b, t in _batches(cfg, tmesh):
        tb = shapes.token_batch_specs(cfg, b, t)
        jb = jshapes.token_batch_specs(jcfg, b, t)
        _specs_equal(jsharding.shard_batch_dim(jmesh, jb, default_dim=0),
                     sharding.shard_batch_dim(tmesh, tb, default_dim=0), tb)
        if "positions" in tb:
            for dim in (1, 0):
                j = jsteps._pos_shard(jmesh, jb["positions"], dim=dim)
                t_ = steps._pos_shard(tmesh, tb["positions"], dim=dim)
                assert tuple(j.spec) == t_.spec
    for s in shapes.SHAPES.values():
        if s.kind != "decode":
            continue
        c = shapes.config_for_shape(cfg, s)
        jc = jshapes.config_for_shape(jcfg, jshapes.SHAPES[s.name])
        tc = shapes.cache_specs(c, s.global_batch, s.seq_len)
        jcache = jshapes.cache_specs(jc, s.global_batch, s.seq_len)
        _specs_equal(jsteps._cache_shardings(jc, jmesh, jcache),
                     steps._cache_shardings(c, tmesh, tc), tc)


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert dict(single.shape) == {"data": 32, "model": 8}
    assert dict(multi.shape) == {"pod": 2, "data": 32, "model": 8}
    assert (single.size, multi.size) == (256, 512)
    assert single.axis_names == ("data", "model")
    assert sharding.batch_axes(multi) == ("pod", "data")
    assert sharding.batch_total(multi) == 64
    spec = sharding.NamedSpec(multi, (("pod", "data"), None, "model"))
    assert spec.shard_shape((128, 3, 16)) == (2, 3, 2)
    with pytest.raises(ValueError):
        spec.shard_shape((100, 3, 16))
    x = torch.ones(3)
    assert sharding.constrain(x, "batch") is x


# ------------------------------------------------------------ (d) specs


def _same_shapes(jtree, ttree):
    jl = _jleaves(jtree)
    tl = _tleaves(ttree)
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (keys, j), (_, t) in zip(jl, tl):
        assert t.device.type == "meta"
        assert tuple(j.shape) == tuple(t.shape), keys
        assert jnp.dtype(j.dtype) == _jdtype(t.dtype), keys


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_eval_shape(arch):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    for s in shapes.SHAPES.values():
        c = shapes.config_for_shape(cfg, s)
        jc = jshapes.config_for_shape(jcfg, jshapes.SHAPES[s.name])
        b = max(s.global_batch // 32, 1)
        if s.kind == "decode":
            _same_shapes(jshapes.decode_specs(jc, s.global_batch, s.seq_len),
                         shapes.decode_specs(c, s.global_batch, s.seq_len))
        else:
            _same_shapes(jshapes.token_batch_specs(jc, b, s.seq_len),
                         shapes.token_batch_specs(c, b, s.seq_len))
