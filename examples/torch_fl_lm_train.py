"""End-to-end federated LANGUAGE-MODEL training with FedAdp, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_fl_lm_train.py --preset small --rounds 50
    PYTHONPATH=src python examples/torch_fl_lm_train.py --preset 100m --rounds 200
    PYTHONPATH=src python examples/torch_fl_lm_train.py --device cpu --rounds 2

Clients hold non-IID token streams (client-permuted Zipf vocabularies);
each round runs tau local SGD steps per client, batched over the clients
with torch.func.vmap(grad), and a FedAdp-weighted aggregation. On CUDA
unless `--device cpu` is given. The flow, presets, defaults and printout
of `examples/fl_lm_train.py`; the full RoundState is saved to `--out`
(default results/fl_lm.npz). `model_config`, `make_round` and
`round_tokens` build the same run for other callers: with
`model_config(preset, "flash")` every local step's attention runs the
flash kernel, and with `FLConfig(engine="flat")` the round's (K, N)
delta buffer streams through the aggregation and statistics kernels.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

PRESETS = {
    # ~20M params: fast CPU demo
    "small": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                  d_ff=1024, vocab_size=8192),
    # ~110M params: the "train a ~100M model" end-to-end driver
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=3072, vocab_size=32768),
}


def model_config(preset: str, attention_impl: str = "xla") -> ModelConfig:
    """The preset's dense f32 LM with tied embeddings."""
    return ModelConfig(name=f"fl-lm-{preset}", arch_type="dense",
                       tie_embeddings=True, dtype="float32",
                       attention_impl=attention_impl, **PRESETS[preset])


def make_round(cfg: ModelConfig, flcfg):
    """The example's round: FedAdp over `transformer.loss_fn`."""
    return repro_torch.make_round_fn(
        lambda p, b: transformer.loss_fn(p, cfg, b), flcfg)


def round_tokens(r: int, clients: int, tau: int, batch: int, seq: int,
                 vocab: int, device) -> dict:
    """Round r's batches: {"tokens": (K, tau, B, T)} on `device`."""
    toks = synthetic.lm_token_batches(
        seed=r, num_clients=clients, batch=tau * batch, seq=seq, vocab=vocab,
    ).reshape(clients, tau, batch, seq)
    return {"tokens": torch.from_numpy(toks).to(device)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="small")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--method", choices=["fedadp", "fedavg"],
                    default="fedadp")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--out", default="results/fl_lm.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, or an error)")
    args = ap.parse_args(argv)
    dev = (repro_torch.default_device() if args.device is None
           else torch.device(args.device))

    cfg = model_config(args.preset)
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    n = transformer.count_params(cfg)
    print(f"model {cfg.name}: {n/1e6:.1f}M params; "
          f"K={args.clients} tau={args.tau} B={args.batch} T={args.seq}")

    flcfg = repro_torch.FLConfig(num_clients=args.clients,
                                 clients_per_round=args.clients,
                                 local_steps=args.tau, method=args.method,
                                 base_lr=args.lr, lr_decay=0.999)
    round_fn = make_round(cfg, flcfg)
    state = repro_torch.init_round_state(flcfg, params)
    sel = torch.arange(args.clients, dtype=torch.int32, device=dev)
    sizes = torch.ones((args.clients,), device=dev)

    for r in range(args.rounds):
        batches = round_tokens(r, args.clients, args.tau, args.batch,
                               args.seq, cfg.vocab_size, dev)
        t0 = time.time()
        state, m = round_fn(state, batches, sel, sizes)
        if r % 5 == 0 or r == args.rounds - 1:
            w = np.asarray(m["weights"].cpu())
            print(f"round {r:4d} loss {float(m['loss']):.4f} "
                  f"div {float(m['divergence']):.3f} "
                  f"w=[{', '.join(f'{x:.3f}' for x in w)}] "
                  f"({time.time()-t0:.1f}s)")
    # full RoundState snapshot: repro_torch.state_from_tree(flcfg,
    # ckpt.load(path), device) rebuilds the exact carry to resume
    path = ckpt.save(args.out, repro_torch.state_to_tree(state))
    print("checkpoint ->", path)


if __name__ == "__main__":
    main()
