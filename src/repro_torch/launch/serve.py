"""Serving: prefill a batch of prompts, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --device cpu --steps 8

`generate` is the flow of the JAX package's `examples/serve_decode.py`:
`transformer.forward(mode="prefill")` on the prompt and the stub inputs
(`extras`: Qwen2-VL's vision patch embeddings, Whisper's encoder frame
embeddings), the argmax of the last position, then `steps - 1` greedy
`decode_step`s. Decode continues at positions P + T, P + T + 1, ...,
where P is the vision prefix's length, in a cache of P + T + steps
positions. (The JAX example decodes at T + i: with a prefix it writes
over, and masks out, the cache slots of the last P prompt positions; the
port does not carry that over.) M-RoPE decode uses the default position
streams, all three equal to the absolute position.

The command line runs the reduced (smoke) variant of an architecture
with random weights from a seed and zero stub embeddings (as the JAX
example feeds them), on CUDA unless `--device cpu` is given, and prints
its timings and the first sample's token ids.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import registry
from repro_torch.models import transformer


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
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = transformer.decode_step(params, cfg, tok, cache,
                                                start + i)
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
    extras = stub_extras(cfg, b, dev)
    t0 = time.perf_counter()
    ids = generate(params, cfg, tokens, args.steps, extras=extras)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[{cfg.name} on {dev}, attention={cfg.attention_impl}] B={b} "
          f"T={t}: {args.steps} tokens/seq in {dt:.3f} s")
    print("sample token ids:", ids[0, :12].tolist())


if __name__ == "__main__":
    main()
