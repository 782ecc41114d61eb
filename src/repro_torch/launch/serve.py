"""Serving: prefill a batch of prompts, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --device cpu --steps 8

`generate` is the flow of the JAX package's `examples/serve_decode.py`:
`transformer.forward(mode="prefill")`, the argmax of the last position,
then `steps - 1` greedy `decode_step`s at positions T, T + 1, ... The
command line runs the reduced (smoke) variant of an architecture with
random weights from a seed, on CUDA unless `--device cpu` is given, and
prints its timings and the first sample's token ids.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import registry
from repro_torch.models import transformer


@torch.no_grad()
def generate(params, cfg, tokens: torch.Tensor, steps: int, *,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy decoding: tokens (B, T) int prompts -> (B, steps) int64
    token ids. The cache holds `max_len` positions (default T + steps)."""
    b, t = tokens.shape
    max_len = max_len or t + steps
    logits, _, cache = transformer.forward(params, cfg, {"tokens": tokens},
                                           mode="prefill", max_len=max_len)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = transformer.decode_step(params, cfg, tok, cache,
                                                t + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    import repro_torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(registry.ARCHS),
                    default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, or an error)")
    args = ap.parse_args(argv)

    dev = (repro_torch.default_device() if args.device is None
           else torch.device(args.device))
    cfg = registry.smoke(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(gen, cfg)
    b, t = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device=dev)
    t0 = time.perf_counter()
    ids = generate(params, cfg, tokens, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[{cfg.name} on {dev}, attention={cfg.attention_impl}] B={b} "
          f"T={t}: {args.steps} tokens/seq in {dt:.3f} s")
    print("sample token ids:", ids[0, :12].tolist())


if __name__ == "__main__":
    main()
