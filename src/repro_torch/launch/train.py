"""Production federated-training launcher: the counterpart of
`repro/launch/train.py`, with the reference's flags plus `--device`.

It runs the round `launch.steps.build_train_step` builds (the step the
dry run traces), on CUDA unless `--device cpu` is given. With
`--host-mesh` it is one process on one device. Without, it runs on a
`torch.distributed` world, one rank a card: under torchrun it starts the
process group itself (NCCL on CUDA, gloo with `--device cpu`), and a
caller that started one already has it used. The mesh is
`launch.mesh.world_mesh`, `make_client_mesh(model=min(8, world))`: one
HGX node's NVLink cards on "model", the nodes on "data" (world 256 is
`make_production_mesh()`'s (32, 8); `--multi-pod` names no other mesh
here, the pods' nodes all sit on "data"). Each client then trains
tensor-parallel over "model" and the state stays in blocks
(`models/tp.py`), initialised straight into them leaf by leaf; a family
that cannot raises NotImplementedError (ROADMAP Queue 1 item 13d). The
DeepSeek family (MLA + MoE) trains so too. A config above 40e9 params
runs the reference's sequential (FSDP) round (`steps.fl_mode_for`): on a
world its state is initialised straight into this rank's blocks on both
axes (`param_pspecs(..., fsdp=True)`), each rank takes its data index's
rows of the batch, and a checkpoint gathers the leaves one by one.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --host-mesh --smoke --rounds 5
  torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch gemma-2b \\
      --seq 1024 --global-batch 4 --rounds 5
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch deepseek-v2-lite-16b --seq 512 --global-batch 4 --rounds 2
  # preemptible runs: --ckpt DIR [--ckpt-every N] snapshots the FULL
  # RoundState (params, angles, EF, generator, round); --resume continues
  # bit-exactly from the latest snapshot:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --host-mesh --rounds 1000 --ckpt /ckpts/run1 --ckpt-every 50 --resume

The batches are round-seeded (`data.synthetic.lm_token_batches(seed=r)`),
so a resumed run sees at round r the stream of the uninterrupted run.
The last line is `params_sha256 <hex>` over the params' bytes in the
tree's leaf order; `main` also returns it with the losses and the
seconds of each round. Off the host mesh the hash and a checkpoint read
the gathered params, leaf by leaf: rank 0 writes the host mesh's file
format, and a resumed rank loads it and keeps its blocks.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time

import torch


def params_sha256(params, mesh=None, specs=None) -> str:
    """SHA-256 of the params' bytes, leaf by leaf in tree order. Given
    the mesh and the spec tree of params held in blocks, of the whole
    params: each leaf gathered to the host before it is hashed."""
    from repro_torch.core import treemath
    from repro_torch.models import sharding

    h = hashlib.sha256()
    leaves = treemath.tree_leaves(params)
    for i, leaf in enumerate(leaves):
        if specs is not None:
            leaf = sharding.gather_params(
                leaf, mesh, treemath.tree_leaves_like(params, specs)[i],
                device="cpu")
        h.update(leaf.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--method", choices=["fedadp", "fedavg"], default="fedadp")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="one-device mesh (this process's device)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--stale", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint DIRECTORY: the full RoundState is "
                         "snapshotted there (atomic, `latest` pointer)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also checkpoint every N rounds (0: only at end)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt; "
                         "training continues bit-exactly at the saved "
                         "round (--rounds is the TOTAL round budget)")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="stream round/node/span telemetry to "
                         "DIR/telemetry.jsonl (summarize with "
                         "scripts/flstat.py). Builds the step with "
                         "FLConfig(telemetry='node')")
    ap.add_argument("--telemetry-every", type=int, default=1, metavar="N",
                    help="emit round/node events only every N rounds "
                         "(spans and manifest always emit)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, or an error)")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt:
        ap.error("--resume needs --ckpt (the directory to resume from)")
    if args.telemetry_every < 1:
        ap.error("--telemetry-every must be >= 1")

    import repro_torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import registry, shapes as shapes_mod
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import (launcher_device, make_host_mesh,
                                         world_mesh)
    from repro_torch.models import sharding, transformer
    from repro_torch.telemetry import report as tel_report
    from repro_torch.telemetry import sinks as tel_sinks
    from repro_torch.telemetry import spans as tel_spans

    dev = launcher_device(args.device, args.host_mesh)
    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = registry.get(name)
    mesh = make_host_mesh(dev) if args.host_mesh else world_mesh(dev)
    shape = shapes_mod.SHAPES["train_4k"]
    if args.seq or args.global_batch:
        shape = dataclasses.replace(
            shape, seq_len=args.seq or shape.seq_len,
            global_batch=args.global_batch or shape.global_batch,
        )

    fn, sds, in_specs, _, meta = steps.build_train_step(
        cfg, mesh, shape, method=args.method, stale=args.stale,
        local_steps=args.tau,
        telemetry="node" if args.telemetry else None,
    )
    K, B, tau = meta["K"], meta["B"], meta["tau"]
    print(f"arch={cfg.name} mode={meta['fl_mode']} K={K} B={B} tau={tau} "
          f"T={shape.seq_len} mesh={dict(mesh.shape)} device={dev}")

    sink = None
    spans = tel_spans.SpanTimer()
    if args.telemetry and mesh.rank == 0:  # one stream a run
        sink = tel_sinks.JSONLSink(os.path.join(args.telemetry,
                                                "telemetry.jsonl"))
        spans = tel_spans.SpanTimer(sink)

    # the exact config build_train_step built the round with: the
    # RoundState's fields are a function of it
    flcfg = repro_torch.FLConfig(**meta["flcfg"])
    # the state's params and prev_delta in this rank's blocks where the
    # mesh has a model axis, and in sequential (FSDP) mode on any mesh of
    # more than one rank, on both axes (None: whole)
    fsdp = meta["fl_mode"] == "sequential"
    specs = (sharding.param_pspecs(sds[0].params, mesh, fsdp=fsdp)
             if mesh.model_size > 1 or (fsdp and mesh.size > 1) else None)

    def placed(tree):
        if specs is None:
            return tree
        return sharding.shard_params(tree, mesh, specs)

    def whole(tree, device=None):
        if specs is None:
            return tree
        return sharding.gather_params(tree, mesh, specs, device=device)

    start = 0
    if args.resume:
        loaded = ckpt_io.load_latest(args.ckpt)
        if loaded is None:
            raise SystemExit(f"--resume: no checkpoint in {args.ckpt}")
        step_no, tree = loaded
        state = repro_torch.state_from_tree(flcfg, tree, dev)
        del tree
        state = state._replace(params=placed(state.params),
                               prev_delta=placed(state.prev_delta))
        start = int(state.round)
        print(f"resumed {args.ckpt} @ round {start} (ckpt_{step_no:08d})")
    else:  # straight into this rank's blocks: no whole model here
        state = repro_torch.init_round_state(flcfg, transformer.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg,
            mesh=None if specs is None else mesh, specs=specs))
    sel = torch.arange(K, dtype=torch.int32, device=dev)
    sizes = torch.ones((K,), device=dev)
    if sink is not None:
        tel_sinks.emit_manifest(sink, flcfg,
                                extra={"arch": cfg.name,
                                       "mesh": dict(mesh.shape),
                                       "start_round": start})

    def checkpoint(round_no: int) -> None:
        with spans.span("checkpoint", round=round_no):
            # the host mesh's format: whole leaves, gathered one by one to
            # the host, written by one rank
            host = "cpu" if specs is not None else None
            tree = repro_torch.state_to_tree(state._replace(
                params=whole(state.params, host),
                prev_delta=whole(state.prev_delta, host)))
            if mesh.rank == 0:
                ckpt_io.save_checkpoint(args.ckpt, round_no, tree)
            del tree
            mesh.barrier()
        print(f"checkpoint -> {args.ckpt} @ round {round_no}")

    losses, seconds = [], []
    for r in range(start, args.rounds):
        # round-seeded synthetic batches: the stream a resumed run sees
        # at round r is identical to the uninterrupted run's
        toks = synthetic.lm_token_batches(
            seed=r, num_clients=K, batch=tau * B, seq=shape.seq_len,
            vocab=cfg.vocab_size,
        ).reshape(K, tau, B, shape.seq_len)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        for k2, spec in sds[1].items():
            if k2 != "tokens":
                batch[k2] = torch.zeros(spec.shape, dtype=spec.dtype,
                                        device=dev)
        if fsdp and specs is not None:  # this data index's rows
            batch = steps.local_batch(batch, in_specs[1], mesh)
        t0 = time.time()
        with spans.span("round", round=r + 1):
            state, m = fn(state, batch, sel, sizes)
            m = {k: v.detach().cpu().numpy() for k, v in m.items()}
        seconds.append(time.time() - t0)
        losses.append(float(m["loss"]))
        print(f"round {r:4d} loss {float(m['loss']):.4f} "
              f"div {float(m['divergence']):.3f} ({seconds[-1]:.1f}s)")
        if sink is not None:
            tel_sinks.emit_round_block(sink, m, r,
                                       every=args.telemetry_every)
        if (args.ckpt and args.ckpt_every
                and (r + 1) % args.ckpt_every == 0):
            checkpoint(r + 1)
    if args.ckpt:
        checkpoint(int(state.round))
    digest = params_sha256(state.params, mesh, specs)
    print("params_sha256", digest)
    if sink is not None:
        tel_sinks.emit_summary(sink, rounds=args.rounds - start)
        sink.close()
        s = tel_report.summarize(tel_sinks.load_events(sink.path))
        print(f"telemetry -> {sink.path}")
        print(tel_report.oneline(s))
    return {"params_sha256": digest, "losses": losses, "seconds": seconds,
            "start_round": start, "meta": meta}


if __name__ == "__main__":
    main()
