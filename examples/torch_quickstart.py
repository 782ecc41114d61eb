"""Quickstart on the PyTorch port: FedAdp vs FedAvg on a non-IID
federated image task.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Ten nodes (5 IID + 5 one-class non-IID), multinomial logistic regression,
on CUDA unless `--device cpu` is given. Reproduces the paper's headline
qualitatively: FedAdp reaches the accuracy target in far fewer
communication rounds. The flow of `examples/quickstart.py`.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, or an error)")
    args = ap.parse_args(argv)
    dev = (repro_torch.default_device() if args.device is None
           else torch.device(args.device))

    print("building synthetic 10-class image task (offline MNIST stand-in)...")
    train, test = synthetic.make_image_task(seed=0, num_train=12000,
                                            num_test=2000)
    nodes = synthetic.make_federated(
        train, [("iid", None)] * 5 + [("xclass", 1)] * 5,
        samples_per_node=600, seed=1,
    )
    target = 0.85
    results = {}
    for method in ("fedavg", "fedadp"):
        cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                   local_steps=12, method=method,
                                   base_lr=0.05)
        server = repro_torch.FedServer("mlr", cfg, nodes, test,
                                       batch_size=50, seed=0, device=dev)
        hist = server.run(rounds=args.rounds, target_acc=target,
                          eval_every=2)
        r = hist.rounds_to_target
        results[method] = r
        print(f"{method:8s}: rounds to {target:.0%} accuracy = "
              f"{r if r else f'>{args.rounds}'} "
              f"(final acc {hist.final_accuracy:.3f})")
    if results["fedadp"] and results["fedavg"]:
        red = 100 * (1 - results["fedadp"] / results["fedavg"])
        print(f"\nFedAdp communication-round reduction: {red:.1f}% "
              f"(paper reports up to 54.1% on MNIST)")


if __name__ == "__main__":
    main()
