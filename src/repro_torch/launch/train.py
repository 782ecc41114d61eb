"""Production federated-training launcher: the counterpart of
`repro/launch/train.py`, with the reference's flags plus `--device`.

It runs the round `launch.steps.build_train_step` builds (the step the
dry run traces), on CUDA unless `--device cpu` is given. Only the host
mesh runs today: training on the production mesh runs each client's
forward and backward tensor-parallel over the mesh's model axis, which
the port does not do yet (ROADMAP Queue 1 item 13c); without
`--host-mesh` the launcher raises NotImplementedError rather than fall
back to one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --host-mesh --smoke --rounds 5
  # preemptible runs: --ckpt DIR [--ckpt-every N] snapshots the FULL
  # RoundState (params, angles, EF, generator, round); --resume continues
  # bit-exactly from the latest snapshot:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --host-mesh --rounds 1000 --ckpt /ckpts/run1 --ckpt-every 50 --resume

The batches are round-seeded (`data.synthetic.lm_token_batches(seed=r)`),
so a resumed run sees at round r the stream of the uninterrupted run.
The last line is `params_sha256 <hex>` over the params' bytes in the
tree's leaf order; `main` also returns it with the losses and the
seconds of each round.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time

import torch


def params_sha256(params) -> str:
    """SHA-256 of the params' bytes, leaf by leaf in tree order."""
    from repro_torch.core import treemath

    h = hashlib.sha256()
    for leaf in treemath.tree_leaves(params):
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
    if not args.host_mesh:
        raise NotImplementedError(
            "training on the production mesh runs each client's forward "
            "and backward tensor-parallel over its model axis, which the "
            "port does not do yet (ROADMAP Queue 1 item 13c: tensor-"
            "parallel model execution); run with --host-mesh")

    import repro_torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import registry, shapes as shapes_mod
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.telemetry import report as tel_report
    from repro_torch.telemetry import sinks as tel_sinks
    from repro_torch.telemetry import spans as tel_spans

    dev = (repro_torch.default_device() if args.device is None
           else torch.device(args.device))
    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = registry.get(name)
    mesh = make_host_mesh(dev)
    shape = shapes_mod.SHAPES["train_4k"]
    if args.seq or args.global_batch:
        shape = dataclasses.replace(
            shape, seq_len=args.seq or shape.seq_len,
            global_batch=args.global_batch or shape.global_batch,
        )

    fn, sds, _, _, meta = steps.build_train_step(
        cfg, mesh, shape, method=args.method, stale=args.stale,
        local_steps=args.tau,
        telemetry="node" if args.telemetry else None,
    )
    K, B, tau = meta["K"], meta["B"], meta["tau"]
    print(f"arch={cfg.name} mode={meta['fl_mode']} K={K} B={B} tau={tau} "
          f"T={shape.seq_len} mesh={dict(mesh.shape)} device={dev}")

    sink = None
    spans = tel_spans.SpanTimer()
    if args.telemetry:
        sink = tel_sinks.JSONLSink(os.path.join(args.telemetry,
                                                "telemetry.jsonl"))
        spans = tel_spans.SpanTimer(sink)

    # the exact config build_train_step built the round with: the
    # RoundState's fields are a function of it
    flcfg = repro_torch.FLConfig(**meta["flcfg"])
    start = 0
    if args.resume:
        loaded = ckpt_io.load_latest(args.ckpt)
        if loaded is None:
            raise SystemExit(f"--resume: no checkpoint in {args.ckpt}")
        step_no, tree = loaded
        state = repro_torch.state_from_tree(flcfg, tree, dev)
        start = int(state.round)
        print(f"resumed {args.ckpt} @ round {start} (ckpt_{step_no:08d})")
    else:
        params = transformer.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
        state = repro_torch.init_round_state(flcfg, params)
    sel = torch.arange(K, dtype=torch.int32, device=dev)
    sizes = torch.ones((K,), device=dev)
    if sink is not None:
        tel_sinks.emit_manifest(sink, flcfg,
                                extra={"arch": cfg.name,
                                       "mesh": dict(mesh.shape),
                                       "start_round": start})

    def checkpoint(round_no: int) -> None:
        with spans.span("checkpoint", round=round_no):
            ckpt_io.save_checkpoint(args.ckpt, round_no,
                                    repro_torch.state_to_tree(state))
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
    digest = params_sha256(state.params)
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
