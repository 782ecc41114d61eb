"""Paper reproduction driver on the PyTorch port: Table I / Figs. 4-7
protocol on the synthetic image task (offline stand-in for
MNIST/FashionMNIST).

    PYTHONPATH=src python examples/torch_fedadp_noniid.py --model mlr --setting 5iid+5non1
    PYTHONPATH=src python examples/torch_fedadp_noniid.py --model cnn --rounds 300

On CUDA unless `--device cpu` is given. Writes per-round
accuracy/loss/divergence JSON to `--out` (default results/). The flow of
`examples/fedadp_noniid.py`.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

SETTINGS = {
    "10iid": [("iid", None)] * 10,
    "3iid+7non1": [("iid", None)] * 3 + [("xclass", 1)] * 7,
    "5iid+5non1": [("iid", None)] * 5 + [("xclass", 1)] * 5,
    "6iid+4non1": [("iid", None)] * 6 + [("xclass", 1)] * 4,
    "3iid+7non2": [("iid", None)] * 3 + [("xclass", 2)] * 7,
    "5iid+5non2": [("iid", None)] * 5 + [("xclass", 2)] * 5,
    "6iid+4non2": [("iid", None)] * 6 + [("xclass", 2)] * 4,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["mlr", "cnn"], default="mlr")
    ap.add_argument("--setting", choices=sorted(SETTINGS),
                    default="5iid+5non1")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--alpha", type=float, default=5.0)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--out", default="results")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, or an error)")
    args = ap.parse_args(argv)
    dev = (repro_torch.default_device() if args.device is None
           else torch.device(args.device))

    batch = args.batch or (32 if args.model == "cnn" else 50)
    lr = args.lr or (0.05 if args.model == "mlr" else 0.02)
    train, test = synthetic.make_image_task(seed=0, num_train=20000,
                                            num_test=3000)
    nodes = synthetic.make_federated(train, SETTINGS[args.setting],
                                     samples_per_node=600, seed=1)
    out = {}
    for method in ("fedavg", "fedadp"):
        cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                   local_steps=600 // batch, method=method,
                                   alpha=args.alpha, base_lr=lr)
        server = repro_torch.FedServer(args.model, cfg, nodes, test,
                                       batch_size=batch, seed=0, device=dev)
        hist = server.run(args.rounds, target_acc=args.target, eval_every=2,
                          verbose=True)
        out[method] = {
            "rounds_to_target": hist.rounds_to_target,
            "accuracy": hist.accuracy,
            "loss": hist.loss,
            "divergence": hist.divergence,
        }
        print(f"[{args.model}/{args.setting}] {method}: rounds-to-"
              f"{args.target:.0%} = {hist.rounds_to_target or 'N/A'}")

    os.makedirs(args.out, exist_ok=True)
    path = f"{args.out}/fedadp_{args.model}_{args.setting}.json"
    with open(path, "w") as f:
        json.dump(out, f)
    print("wrote", path)
    a, b = out["fedadp"]["rounds_to_target"], out["fedavg"]["rounds_to_target"]
    if a and b:
        print(f"round reduction: {100*(1-a/b):.1f}%")


if __name__ == "__main__":
    main()
