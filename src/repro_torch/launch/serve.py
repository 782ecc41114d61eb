"""Serving: prefill a batch of prompts, then greedy decode; and the
production serving launcher, the counterpart of `repro/launch/serve.py`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --device cpu --steps 8
    # the production launcher: decode at mid-cache through
    # launch.steps.build_decode_step, on one device or on a world
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --host-mesh --smoke --shape decode_32k --batch 2 --seq 64 --steps 16
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch gemma-2b --shape decode_32k --batch 4 --seq 4096 --steps 8

`generate` is the flow of the JAX package's `examples/serve_decode.py`:
`transformer.forward(mode="prefill")` on the prompt and the stub inputs
(`extras`: Qwen2-VL's vision patch embeddings, Whisper's encoder frame
embeddings), the argmax of the last position, then `steps - 1` greedy
`decode_step`s. Decode continues at positions P + T, P + T + 1, ...,
where P is the vision prefix's length, in a cache of P + T + steps
positions. (The JAX example decodes at T + i: with a prefix it writes
over, and masks out, the cache slots of the last P prompt positions; the
port does not carry that over.) M-RoPE decode uses the default position
streams, all three equal to the absolute position. Inside a `tp.scope`
it runs on this rank's params (the cache in its blocks) and gathers the
logits of the positions it reads.

Without `--shape` the command line runs `generate` on the reduced
(smoke) variant of an architecture with random weights from a seed and
zero stub embeddings (as the JAX example feeds them), on CUDA unless
`--device cpu` is given, and prints its timings and the first sample's
token ids. With `--shape` it is the reference's launcher: the shape's
batch and cache length (`--batch` / `--seq` override them; `--seq`
sizes the cache), `--smoke` for the reduced config, and on `--host-mesh`
one device, else the world mesh of `launch.mesh.world_mesh` (under
torchrun, or in a process group the caller started), each rank holding
its blocks of the params (initialised into them) and of the cache. It
decodes `--steps` greedy tokens from zero tokens at mid-cache through
`build_decode_step`'s fn, prints ms/token with the first step left out,
and the tokens.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import registry
from repro_torch.models import tp, transformer


def stub_extras(cfg, b: int, device) -> dict:
    """Zero stub embeddings for the architectures that take them, as the
    JAX package's `examples/serve_decode.py` builds them: (B, P, d)
    `vision_embeds` and (B, encoder_len, d) `enc_embeds`."""
    out = {}
    if cfg.vision_prefix:
        out["vision_embeds"] = torch.zeros(
            (b, cfg.vision_prefix, cfg.d_model), dtype=cfg.tdtype,
            device=device)
    if cfg.encoder_layers:
        out["enc_embeds"] = torch.zeros(
            (b, cfg.encoder_len, cfg.d_model), dtype=cfg.tdtype,
            device=device)
    return out


@torch.no_grad()
def generate(params, cfg, tokens: torch.Tensor, steps: int, *,
             max_len: Optional[int] = None,
             extras: Optional[dict] = None) -> torch.Tensor:
    """Greedy decoding: tokens (B, T) int prompts -> (B, steps) int64
    token ids. `extras` joins the prefill's batch (the stub embeddings of
    `stub_extras`). The cache holds `max_len` positions (default
    P + T + steps)."""
    batch = {"tokens": tokens, **(extras or {})}
    start = tokens.shape[1] + cfg.vision_prefix  # P + T
    max_len = max_len or start + steps
    logits, _, cache = transformer.forward(params, cfg, batch,
                                           mode="prefill", max_len=max_len)
    # inside a tp.scope: the last position's vocab blocks joined
    tok = torch.argmax(tp.gather_logits(logits[:, -1:], cfg.vocab_size),
                       dim=-1)
    del logits
    out = [tok]
    for i in range(steps - 1):
        logits, cache = transformer.decode_step(params, cfg, tok, cache,
                                                start + i)
        tok = torch.argmax(tp.gather_logits(logits, cfg.vocab_size), dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1)


@torch.no_grad()
def serve_shape(cfg, shape, mesh, dev, steps: int) -> dict:
    """The reference launcher's decode loop: `build_decode_step`'s fn on
    `mesh` from zero tokens at mid-cache (position seq // 2), `steps`
    greedy steps on params from seed 0 (this rank's blocks where the mesh
    has a model axis) and a zero cache. Returns the global batch's tokens
    (B, steps), the host's ms a token over steps 2 .. steps, and the
    config run."""
    from repro_torch.configs import shapes as shapes_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import sharding

    fn, sds, _, _, meta = steps_mod.build_decode_step(cfg, mesh, shape)
    cfg2 = shapes_mod.config_for_shape(cfg, shape)
    b, s = meta["B"], meta["S"]
    blocks = steps_mod._tensor_parallel(mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(
        gen, cfg2, mesh=mesh if blocks else None,
        specs=sharding.param_pspecs(sds[0], mesh) if blocks else None)
    cache = transformer.init_cache(cfg2, b, s, device=dev,
                                   mesh=mesh if blocks else None)
    rows = b // sharding.batch_total(mesh) if blocks else b
    tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    pos = s // 2  # mid-cache decode position
    out, t0 = [], None
    for i in range(steps):
        logits, cache = fn(params, tok, cache, pos + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        if i == 0:
            _sync(dev)
            t0 = time.perf_counter()  # the first step left out
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    ids = torch.cat(out, dim=1)
    if blocks:  # every data index's rows
        ids = mesh.all_gather(ids, axes=("data",), dim=0)
    return {"tokens": ids.cpu(), "ms_per_token": ms, "cfg": cfg2}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    import repro_torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(registry.ARCHS),
                    default="gemma-2b")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch (default 4; with --shape, the shape's)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=None,
                    help="tokens a sequence (default 16; with --shape 8)")
    ap.add_argument("--shape", default=None,
                    help="run the production launcher at this input shape "
                         "(e.g. decode_32k)")
    ap.add_argument("--seq", type=int, default=None,
                    help="with --shape: the cache length")
    ap.add_argument("--host-mesh", action="store_true",
                    help="with --shape: one device, no process group")
    ap.add_argument("--smoke", action="store_true",
                    help="with --shape: the reduced same-family config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, or an error)")
    args = ap.parse_args(argv)

    if args.shape is not None:
        return _main_shape(args)
    dev = (repro_torch.default_device() if args.device is None
           else torch.device(args.device))
    cfg = registry.smoke(args.arch)
    steps = args.steps or 16
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(gen, cfg)
    b, t = args.batch or 4, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device=dev)
    extras = stub_extras(cfg, b, dev)
    t0 = time.perf_counter()
    ids = generate(params, cfg, tokens, steps, extras=extras)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[{cfg.name} on {dev}, attention={cfg.attention_impl}] B={b} "
          f"T={t}: {steps} tokens/seq in {dt:.3f} s")
    print("sample token ids:", ids[0, :12].tolist())
    return {"tokens": ids.cpu(), "seconds": dt}


def _main_shape(args) -> dict:
    """The production launcher (`--shape`)."""
    import dataclasses

    from repro_torch.configs import shapes as shapes_mod
    from repro_torch.launch.mesh import (launcher_device, make_host_mesh,
                                         world_mesh)

    dev = launcher_device(args.device, args.host_mesh)
    cfg = registry.get(args.arch + ("-smoke" if args.smoke else ""))
    mesh = make_host_mesh(dev) if args.host_mesh else world_mesh(dev)
    shape = shapes_mod.SHAPES[args.shape]
    if args.batch or args.seq:
        shape = dataclasses.replace(
            shape, global_batch=args.batch or shape.global_batch,
            seq_len=args.seq or shape.seq_len)
    res = serve_shape(cfg, shape, mesh, dev, args.steps or 8)
    print(f"[{res['cfg'].name} x {shape.name}] B={shape.global_batch} "
          f"cache={shape.seq_len} mesh={dict(mesh.shape)}: "
          f"{res['ms_per_token']:.1f} ms/token (host measure)")
    print("tokens:", res["tokens"].tolist())
    return res


if __name__ == "__main__":
    main()
