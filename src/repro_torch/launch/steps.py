"""Step builders shared by the dry run and the training launcher: the
counterpart of `repro/launch/steps.py`, builder for builder.

Each builder returns `(fn, args, in_specs, out_specs, meta)`. `args` are
tensors on the "meta" device at the step's global shapes (the port's
`jax.ShapeDtypeStruct` trees): `fn(*args)` runs the whole step on meta
and allocates nothing, and the same `fn` runs on real tensors of those
shapes. `in_specs` / `out_specs` are `models.sharding.NamedSpec` trees
(where the reference has `NamedSharding`s); as in JAX, a spec at a node
of the tree covers every leaf below it. The train step's `RoundState`
carries its generator and its round as host values, which have no spec
(None in `in_specs`).

The builders take the reference's model path: `attention_impl` as the
config has it ("xla" in the registry), and on an abstract mesh (the dry
run's) or the host mesh the tree engine, where the specs say where each
tensor lives and the step runs as one program. Given a
`launch.mesh.ClientMesh` with a model axis, `build_train_step` builds
what the reference's partitioner makes of its step: the round with
`engine="flat_sharded"` over the mesh (the clients split over "data",
as GSPMD splits the reference's tree round) and `param_specs`, so each
client trains tensor-parallel over "model"; its `fn` then takes and
returns a state whose params and `prev_delta` are this rank's blocks
(`models.sharding.shard_params`), while `args` keep the global shapes.
The reference's `delta_constraint` and `grad_constraint` are identities
here, passed to `make_round_fn` where the reference passes its
constraints: the activations need none (`models/tp.py`).

In sequential mode (`fl_mode="sequential"`, the reference's FSDP
mode) on a `ClientMesh` of more than one rank, `build_train_step`
builds the sequential round with `param_specs=param_pspecs(...,
fsdp=True)`: its `fn` takes and returns this rank's blocks of the state
on both axes, and takes this data index's rows of each client's batch
(the batch's B dim as the in_specs split it: `local_batch`), all rows
where B does not split over "data".

Given a `ClientMesh` of more than one rank, `build_prefill_step` and
`build_decode_step` build the serving steps the reference's partitioner
makes: their `fn` runs in `tp.scope(mesh, ...)` on this rank's params
(`sharding.param_pspecs(..., fsdp=)`, e.g. from
`transformer.init_params(..., mesh=, specs=)`; with `fsdp` each group
is gathered over "data" where it runs), this data index's batch rows
(all of them where B does not split over "data") and its cache blocks
(`sharding.cache_pspecs`, e.g. `transformer.init_cache(..., mesh=)`;
where B does not split, the sequence of the attention caches goes on
"data"; the cross-attention cache's encoder positions follow their own
length), and returns the rows' logits whole (gathered over "model" at
the one position read) and the cache blocks. `args` keep the global
shapes. Every family of the registry builds these steps.
"""
from __future__ import annotations

import dataclasses
import torch

from repro_torch.configs import shapes as shapes_mod
from repro_torch.configs.registry import get as get_arch
from repro_torch.core import fl as fl_mod
from repro_torch.core import treemath
from repro_torch.core.weighting import AngleState
from repro_torch.launch.mesh import ClientMesh
from repro_torch.models import sharding, tp, transformer
from repro_torch.models.config import ModelConfig

SEQUENTIAL_THRESHOLD = 40e9  # params; larger models use the sequential engine


def fl_mode_for(cfg: ModelConfig) -> str:
    return "sequential" if cfg.param_count() > SEQUENTIAL_THRESHOLD else "parallel"


def _replicate_extra(cfg: ModelConfig, mesh, mqa_replicate_kv: bool):
    """KV projections to replicate when heads can't fill the model axis."""
    if mqa_replicate_kv and cfg.num_kv_heads < mesh.shape.get("model", 1):
        return frozenset({"wk", "wv"})
    return frozenset()


def params_sds(cfg: ModelConfig):
    """The param tree of `cfg` on the meta device."""
    return transformer.init_params(None, cfg, device="meta")


def _identity(tree):
    return tree


def _tensor_parallel(mesh) -> bool:
    """Whether `mesh` is a process group's mesh of more than one rank:
    the serving builders then build the steps that run on this rank's
    blocks (and rows)."""
    return isinstance(mesh, ClientMesh) and mesh.size > 1


def rows_split(mesh, batch: int) -> bool:
    """Whether a global batch of `batch` rows splits over the mesh's
    batch axes (else every data rank holds every row)."""
    total = sharding.batch_total(mesh)
    return batch % total == 0 and batch >= total


_CROSS = ("cross_k", "cross_v")  # the cross-attention cache's leaves


def _seq_over_data(mesh, cache_sds, cross: bool) -> bool:
    """Whether the cache rules put the sequence of an attention cache on
    "data" (a batch that does not split there): of a self-attention
    cache, or with `cross` of the cross-attention cache, whose encoder
    positions follow their own length."""
    specs = sharding.cache_pspecs(cache_sds, mesh)
    return any(len(spec) > 2 and spec[2] == "data"
               for path, spec in zip(
                   treemath.tree_paths(cache_sds),
                   treemath.tree_leaves_like(cache_sds, specs))
               if (path[-1] in _CROSS) == cross)


def _serving_scope(mesh, fsdp: bool, batch: int, p_sds, cache_sds):
    """A serving step's `tp.scope` as a callable: on a `ClientMesh` of
    more than one rank the step's rows over "data" where the batch
    splits there, the params' FSDP specs with `fsdp`, and each
    attention cache's sequence on "data" where its rules put it there;
    an empty scope elsewhere."""
    if not _tensor_parallel(mesh):
        return lambda: tp.scope(None)
    split = rows_split(mesh, batch)
    specs = sharding.param_pspecs(p_sds, mesh, fsdp=True) if fsdp else None
    seq, cross = (not split and _seq_over_data(mesh, cache_sds, c)
                  for c in (False, True))
    return lambda: tp.scope(mesh, rows_over_data=split, specs=specs,
                            seq_over_data=seq, cross_over_data=cross)


def local_batch(batch, in_specs, mesh):
    """This rank's part of a global batch tree under its `NamedSpec`
    tree (the builders' batch in_specs): this data index's rows, or all
    of them where the spec replicates them."""
    return {k: sharding.block(v, mesh, in_specs[k].spec)
            for k, v in batch.items()}


def rank_blocks(specs, tree, mesh):
    """This rank's block (`sharding.block`) of every tensor of `tree`
    under its `NamedSpec` tree `specs`, in the tree's structure: a spec
    at a node covers the subtree, and None leaves host values as they
    are (`spec_leaves`' reading of the specs)."""
    if isinstance(specs, sharding.NamedSpec):
        return treemath.tree_map(
            lambda x: (sharding.block(x, mesh, specs.spec)
                       if isinstance(x, torch.Tensor) else x), tree)
    if specs is None or isinstance(tree, torch.Tensor):
        if isinstance(tree, torch.Tensor):
            raise ValueError(f"no spec for a tensor of shape "
                             f"{tuple(tree.shape)}")
        return tree
    if isinstance(tree, dict):
        return {k: rank_blocks(specs[k], v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [rank_blocks(s, t, mesh) for s, t in zip(specs, tree)]
        return (type(tree)(*parts) if hasattr(tree, "_fields")
                else type(tree)(parts))
    return tree


# ------------------------------------------------------------- train


def build_train_step(cfg: ModelConfig, mesh, shape: shapes_mod.InputShape,
                     *, fl_mode: str | None = None, method: str = "fedadp",
                     stale: bool = False, local_steps: int = 1,
                     q_chunk: int = 0, angle_filter: str = "all",
                     mqa_replicate_kv: bool = False,
                     ssm_unroll: int = 0, loss_chunk: int = 0,
                     rs_grads: bool = False, ssm_stream_bf16: bool = False,
                     act_constrain: bool = False, moe_combine_bf16: bool = False,
                     telemetry: str | None = None):
    if q_chunk:
        cfg = dataclasses.replace(cfg, q_chunk=q_chunk)
    if loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    if ssm_unroll and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, scan_unroll=ssm_unroll))
    if ssm_stream_bf16 and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, stream_dtype="bfloat16"))
    if act_constrain:
        cfg = dataclasses.replace(cfg, act_constrain=True)
        sharding.set_constraint_mesh(mesh)
    if moe_combine_bf16 and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, combine_dtype="bfloat16"))
    rep_extra = _replicate_extra(cfg, mesh, mqa_replicate_kv)
    fl_mode = fl_mode or fl_mode_for(cfg)
    # a process group's mesh with a model axis: the tensor-parallel
    # round; in sequential mode, any mesh of more than one rank: FSDP
    tensor_parallel = (isinstance(mesh, ClientMesh) and mesh.model_size > 1
                       and fl_mode == "parallel")
    fsdp_round = fl_mode == "sequential" and _tensor_parallel(mesh)
    K = sharding.batch_total(mesh) if fl_mode == "parallel" else 16
    B = max(shape.global_batch // K, 1)
    tau = local_steps

    def loss(params, batch):
        return transformer.loss_fn(params, cfg, batch)

    # telemetry=None keeps the round telemetry-free; "node" adds the
    # per-node tel/* metrics and flows through meta["flcfg"]
    flcfg = fl_mod.FLConfig(
        num_clients=K, clients_per_round=K, local_steps=tau, method=method,
        mode=fl_mode, stale_angles=stale, telemetry=telemetry,
        engine="flat_sharded" if tensor_parallel else "tree",
    )

    p_sds = params_sds(cfg)
    # the state comes from the same init the runtime uses (on meta)
    state_sds = fl_mod.init_round_state(flcfg, p_sds)
    batch_one = shapes_mod.token_batch_specs(cfg, B, shape.seq_len)
    batch_sds = {k: shapes_mod.spec((K, tau) + tuple(v.shape), v.dtype)
                 for k, v in batch_one.items()}
    args = (state_sds, batch_sds, shapes_mod.spec((K,), torch.int32),
            shapes_mod.spec((K,), torch.float32))

    fsdp = fl_mode == "sequential"
    p_shard = sharding.param_shardings(p_sds, mesh, fsdp=fsdp,
                                       replicate_extra=rep_extra)
    # the reference's sharding constraints; without a partitioner each
    # is the identity, passed where the reference passes its own
    delta_constraint = _identity if fl_mode == "parallel" else None
    grad_constraint = (_identity if fl_mode == "sequential" and rs_grads
                       else None)
    angle_pred = (
        fl_mod.moe_dense_only_pred
        if (angle_filter == "dense_only" and cfg.moe is not None)
        else None
    )
    if tensor_parallel or fsdp_round:
        round_fn = fl_mod.make_round_fn(
            loss, flcfg, delta_constraint, angle_pred, grad_constraint,
            mesh=mesh, param_specs=sharding.param_pspecs(
                p_sds, mesh, fsdp=fsdp, replicate_extra=rep_extra),
            rows_over_data=rows_split(mesh, B))
    else:
        round_fn = fl_mod.make_round_fn(loss, flcfg, delta_constraint,
                                        angle_pred, grad_constraint)
    if fl_mode == "parallel":
        b_shard = sharding.shard_batch_dim(mesh, batch_sds, default_dim=0)
    else:
        # K is the scan axis; shard the within-client batch dim instead
        # (positions (K, tau, 3, B, T): B at dim 3)
        b_shard = {k: _pos_shard(mesh, v, dim=3 if k == "positions" else 2)
                   for k, v in batch_sds.items()}
    rep = sharding.NamedSpec(mesh, ())
    state_shard = fl_mod.RoundState(
        params=p_shard, angle=AngleState(rep, rep), prev_delta=p_shard,
        ef=None, dl_ef=None, bcast=None, rng=None, round=None)
    in_shard = (state_shard, b_shard, rep, rep)
    out_shard = (state_shard, rep)  # the metrics: every leaf replicated
    meta = {"K": K, "B": B, "tau": tau, "fl_mode": fl_mode,
            "flcfg": dataclasses.asdict(flcfg)}
    return round_fn, args, in_shard, out_shard, meta


# ------------------------------------------------------------ prefill


def build_prefill_step(cfg: ModelConfig, mesh, shape: shapes_mod.InputShape,
                       *, fsdp: bool | None = None, q_chunk: int = 0):
    if q_chunk:
        cfg = dataclasses.replace(cfg, q_chunk=q_chunk)
    B, T = shape.global_batch, shape.seq_len
    if fsdp is None:
        fsdp = cfg.param_count() > SEQUENTIAL_THRESHOLD
    p_sds = params_sds(cfg)
    batch_sds = shapes_mod.token_batch_specs(cfg, B, T)
    cache_sds = shapes_mod.cache_specs(cfg, B, T + cfg.vision_prefix)
    scope = _serving_scope(mesh, fsdp, B, p_sds, cache_sds)

    def prefill_step(params, batch):
        with scope():
            logits, aux, cache = transformer.forward(
                params, cfg, batch, mode="prefill", max_len=T
            )
            return tp.gather_logits(logits[:, -1:], cfg.vocab_size), cache

    p_shard = sharding.param_shardings(p_sds, mesh, fsdp=fsdp)
    b_shard = sharding.shard_batch_dim(mesh, batch_sds, default_dim=0)
    if "positions" in batch_sds:
        b_shard["positions"] = _pos_shard(mesh, batch_sds["positions"], dim=1)
    # the outputs' shapes, without running the step: the last position's
    # logits, and a cache of every prompt position (the vision prefix's
    # too) laid out as init_cache lays it out
    logits_sds = shapes_mod.spec((B, 1, cfg.vocab_size), cfg.tdtype)
    out_shard = (
        sharding.shard_batch_dim(mesh, logits_sds, default_dim=0),
        _cache_shardings(cfg, mesh, cache_sds),
    )
    return (prefill_step, (p_sds, batch_sds), (p_shard, b_shard), out_shard,
            {"B": B, "T": T})


def _pos_shard(mesh, x, dim):
    spec = [None] * len(x.shape)
    total = sharding.batch_total(mesh)
    if x.shape[dim] % total == 0 and x.shape[dim] >= total:
        spec[dim] = sharding.batch_spec_entry(mesh)
    return sharding.NamedSpec(mesh, tuple(spec))


# ------------------------------------------------------------- decode


def _cache_shardings(cfg, mesh, cache_sds):
    """The decode cache's `NamedSpec` tree (`sharding.cache_pspecs`)."""
    specs = sharding.cache_pspecs(cache_sds, mesh)
    return sharding.map_leaves(
        lambda keys, x: sharding.NamedSpec(mesh,
                                           sharding.spec_at(specs, keys)),
        cache_sds)


def build_decode_step(cfg: ModelConfig, mesh, shape: shapes_mod.InputShape,
                      *, fsdp: bool | None = None):
    cfg = shapes_mod.config_for_shape(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    if fsdp is None:
        fsdp = cfg.param_count() > SEQUENTIAL_THRESHOLD
    p_sds = params_sds(cfg)
    d = shapes_mod.decode_specs(cfg, B, S)
    scope = _serving_scope(mesh, fsdp, B, p_sds, d["cache"])

    def serve_step(params, token, cache, pos):
        # a meta position has no value; a decode step's shapes and work
        # do not depend on it, so the dry run decodes at position 0
        pos = 0 if getattr(pos, "device", None) == shapes_mod.META \
            else int(pos)
        with scope():
            logits, cache = transformer.decode_step(params, cfg, token,
                                                    cache, pos)
            return tp.gather_logits(logits, cfg.vocab_size), cache

    p_shard = sharding.param_shardings(p_sds, mesh, fsdp=fsdp)
    tok_shard = sharding.shard_batch_dim(mesh, d["token"], default_dim=0)
    cache_shard = _cache_shardings(cfg, mesh, d["cache"])
    pos_shard = sharding.NamedSpec(mesh, ())
    args = (p_sds, d["token"], d["cache"], d["pos"])
    in_shard = (p_shard, tok_shard, cache_shard, pos_shard)
    logits_sds = shapes_mod.spec((B, 1, cfg.vocab_size), cfg.tdtype)
    out_shard = (
        sharding.shard_batch_dim(mesh, logits_sds, default_dim=0),
        cache_shard,  # the step writes the cache in place and returns it
    )
    return serve_step, args, in_shard, out_shard, {"B": B, "S": S,
                                                   "window": cfg.sliding_window}


def build_step(arch: str, shape_name: str, mesh, **kw):
    cfg = get_arch(arch)
    shape = shapes_mod.SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_decode_step(cfg, mesh, shape, **kw)


def spec_leaves(specs, tree) -> list:
    """[(NamedSpec, tensor)] over every tensor of `tree`, each with the
    spec at or above it in `specs` (a spec at a node covers the subtree;
    None covers host values, which are skipped)."""
    if isinstance(specs, sharding.NamedSpec):
        return [(specs, x) for x in treemath.tree_leaves(tree)
                if isinstance(x, torch.Tensor)]
    if specs is None or isinstance(tree, torch.Tensor):
        if isinstance(tree, torch.Tensor):
            raise ValueError(f"no spec for a tensor of shape "
                             f"{tuple(tree.shape)}")
        return []
    if isinstance(tree, dict):
        if set(specs) != set(tree):
            raise ValueError(f"spec keys {sorted(specs)} != tree keys "
                             f"{sorted(tree)}")
        return [p for k in sorted(tree) for p in spec_leaves(specs[k], tree[k])]
    if isinstance(tree, (list, tuple)):
        return [p for s, t in zip(specs, tree) for p in spec_leaves(s, t)]
    return []
