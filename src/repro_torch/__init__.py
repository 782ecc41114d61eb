"""FedAdp in PyTorch for one NVIDIA Hopper GPU: the port of `repro`.

The synchronous FedAdp round of the flat engine (paper Eqs. 8-11) with
its two passes over the (K, N) client-delta buffer written by hand in
CUDA C++ (`repro_torch.kernels`). Modules mirror the JAX package's names:

    import repro_torch

    cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                               local_steps=12, engine="flat")
    server = repro_torch.FedServer("cnn", cfg, nodes, test, batch_size=50)
    hist = server.run(60, target_acc=0.85)

Entry points run on CUDA unless the caller passes device="cpu"; without a
GPU they raise rather than fall back. This package never imports jax or
the JAX package.
"""
import torch


def default_device() -> torch.device:
    """torch.device("cuda"), or RuntimeError when torch sees no GPU: the
    port never falls back to the CPU quietly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch sees no GPU; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


from repro_torch.core.fl import (  # noqa: E402
    FLConfig,
    init_round_state,
    make_round_fn,
)
from repro_torch.core.server import FedServer  # noqa: E402

__all__ = [
    "FLConfig",
    "FedServer",
    "default_device",
    "init_round_state",
    "make_round_fn",
]
