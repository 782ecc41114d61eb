"""Serving demo on the PyTorch port: prefill + batched greedy decode
(the reduced same-family variant of an architecture, random weights from
a seed).

    PYTHONPATH=src python examples/torch_serve_decode.py --arch gemma-2b
    PYTHONPATH=src python examples/torch_serve_decode.py --arch gemma-2b --device cpu

On CUDA unless `--device cpu` is given. Every architecture of the
registry runs: dense, MoE with MLA, the Mamba hybrid, RWKV-6, Whisper
(zero stub encoder frames) and Qwen2-VL (a zero stub vision prefix), as
`examples/serve_decode.py` feeds them. The flow of that example, through
`repro_torch.launch.serve.generate`, which decodes after the vision
prefix (positions P + T + i).
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(registry.ARCHS),
                    default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
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
    extras = serve.stub_extras(cfg, b, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    first = serve.generate(params, cfg, tokens, 1,  # the prefill alone
                           extras=extras)
    sync()
    prefill_s = time.perf_counter() - t0
    print(f"[{cfg.name}] prefill B={b} T={t}: {prefill_s:.2f}s")
    t0 = time.perf_counter()
    ids = serve.generate(params, cfg, tokens, args.steps, extras=extras)
    sync()
    dt = (time.perf_counter() - t0 - prefill_s) / max(args.steps - 1, 1)
    if not torch.equal(ids[:, :1], first):
        raise RuntimeError("the prefill chose another first token")
    print(f"decoded {args.steps} tokens/seq, {dt*1e3:.1f} ms/step/batch")
    print("sample token ids:", ids[0, :12].tolist())


if __name__ == "__main__":
    main()
