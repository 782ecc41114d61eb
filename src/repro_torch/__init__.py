"""FedAdp in PyTorch for one NVIDIA Hopper GPU: the port of `repro`.

The FedAdp round (paper Eqs. 8-11) with its passes over the (K, N)
client-delta buffer written by hand in CUDA C++ (`repro_torch.kernels`):
the parallel round on every uplink and downlink wire, sequential mode and
the buffered-async server; stepwise or scanned runs, checkpoints with a
bit-exact kill/resume, and round telemetry; and the client-sharded
engine (`engine="flat_sharded"`) over the ranks of a `torch.distributed`
client mesh (`make_client_mesh`). Modules mirror the JAX package's
names, and `__all__` mirrors `repro.__all__` plus the mesh and
`default_device`:

    import repro_torch

    cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                               local_steps=12, engine="flat")
    server = repro_torch.FedServer("cnn", cfg, nodes, test, batch_size=50)
    hist = server.run(60, target_acc=0.85, mode="scanned", block=8,
                      ckpt_dir="ckpts", sink=repro_torch.MemorySink())

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


from repro_torch import telemetry, transport  # noqa: E402
from repro_torch.core.fl import (  # noqa: E402
    FLConfig,
    RoundState,
    init_round_state,
    make_round_fn,
    state_from_tree,
    state_to_tree,
)
from repro_torch.launch.mesh import (  # noqa: E402
    ClientMesh,
    make_client_mesh,
    make_host_mesh,
)
from repro_torch.core.server import (  # noqa: E402
    FedServer,
    History,
    fixed_arrival_schedule,
)
from repro_torch.telemetry.manifest import run_manifest  # noqa: E402
from repro_torch.telemetry.sinks import (  # noqa: E402
    CSVSink,
    JSONLSink,
    MemorySink,
)
from repro_torch.telemetry.spans import SpanTimer  # noqa: E402

__all__ = [
    "CSVSink",
    "ClientMesh",
    "FLConfig",
    "FedServer",
    "History",
    "JSONLSink",
    "MemorySink",
    "RoundState",
    "SpanTimer",
    "default_device",
    "fixed_arrival_schedule",
    "init_round_state",
    "make_client_mesh",
    "make_host_mesh",
    "make_round_fn",
    "run_manifest",
    "state_from_tree",
    "state_to_tree",
    "telemetry",
    "transport",
]
