"""The port's driver and server on the CPU.

* The MLR golden task (tests/golden/convergence.json `task`: 5 IID + 5
  one-class nodes of 600 samples, batch 50, lr 0.05, eval every round,
  85% within 60 rounds) through `FedServer(device="cpu")`, flat engine:
  fedadp reaches the target in no more rounds than fedavg. The port's
  generator streams are not JAX's, so the golden counts themselves are
  not expected.
* Device policy: `device=None` means CUDA and raises without a GPU.
* Configs outside the slice raise: the client-sharded engine without a
  mesh ValueError (as the reference), on a mesh with a model axis (the
  2D layout) NotImplementedError; its state builds as in the reference.
* The client batching (torch.func.vmap over grad) against a per-client
  loop, and the epoch batcher's stream property.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import driver, fl, fl_shard_map
from repro_torch.data import synthetic
from repro_torch.models import small

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "convergence.json")


@pytest.fixture(scope="module")
def golden_task():
    with open(GOLDEN) as f:
        task = json.load(f)["task"]
    train, test = synthetic.make_image_task(num_train=12000, num_test=2000)
    spec = [("iid", None)] * 5 + [("xclass", 1)] * 5
    nodes = synthetic.make_federated(train, spec, samples_per_node=600,
                                     seed=task["seed"] + 1)
    return task, nodes, test


def _rounds_to_target(method, task, nodes, test):
    cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                               local_steps=12, method=method, engine="flat",
                               base_lr=0.05)
    server = repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50,
                                   seed=task["seed"], device="cpu")
    hist = server.run(task["max_rounds"], target_acc=task["target"],
                      eval_every=task["eval_every"])
    assert len(hist.loss) == (hist.rounds_to_target or task["max_rounds"])
    for w in hist.weights:
        assert abs(float(np.sum(w)) - 1.0) < 1e-6
    return hist.rounds_to_target


def test_golden_fedadp_no_slower_than_fedavg(golden_task):
    task, nodes, test = golden_task
    adp = _rounds_to_target("fedadp", task, nodes, test)
    avg = _rounds_to_target("fedavg", task, nodes, test)
    assert adp is not None, "fedadp never reached the target"
    assert avg is None or adp <= avg, (adp, avg)


def test_default_device_is_cuda_or_raises(monkeypatch, golden_task):
    _, nodes, test = golden_task
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                               local_steps=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.default_device()


@pytest.mark.parametrize("change", [
    dict(engine="flat_sharded"),
    dict(transport="bf16", error_feedback=True, engine="flat_sharded"),
    dict(engine="flat_sharded", telemetry="node"),
])
def test_configs_outside_the_slice_raise(change):
    cfg = fl.FLConfig(num_clients=4, clients_per_round=4, local_steps=1,
                      **change).validate()
    with pytest.raises(ValueError, match="pass mesh="):
        fl.make_round_fn(lambda p, b: 0.0, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl_shard_map.make_round_ops_2d(
            repro_torch.make_host_mesh("cpu"), {}, {}, alpha=cfg.alpha,
            method=cfg.method, transport=cfg.transport,
            group_size=cfg.group_size)
    params = {"w": torch.zeros(3)}
    state = fl.init_round_state(cfg, params)
    assert state.angle.count.shape == (4,)


def test_validate_keeps_the_reference_checks():
    with pytest.raises(ValueError, match="engine"):
        fl.FLConfig(1, 1, 1, engine="nope").validate()
    with pytest.raises(ValueError, match="error_feedback"):
        fl.FLConfig(1, 1, 1, error_feedback=True).validate()
    with pytest.raises(ValueError, match="group_size"):
        fl.FLConfig(1, 1, 1, transport="int4", group_size=3).validate()
    with pytest.raises(ValueError, match="buffered"):
        fl.FLConfig(1, 1, 1, buffer_m=1).validate()


def test_server_rejects_what_is_not_ported(golden_task):
    """Since the client-sharded engine is ported, the server refuses, as
    the reference does, that engine without a mesh and an unknown run
    mode; a mesh that is not a ClientMesh raises TypeError, and the 2D
    (client x model) layout's entry points, not ported yet, name item
    13b."""
    _, nodes, test = golden_task
    cfg = fl.FLConfig(num_clients=10, clients_per_round=10, local_steps=12)
    sharded = dataclasses.replace(cfg, engine="flat_sharded")
    with pytest.raises(ValueError, match="pass mesh="):
        repro_torch.FedServer("mlr", sharded, nodes, test, batch_size=50,
                              device="cpu")
    with pytest.raises(TypeError, match="ClientMesh"):
        repro_torch.FedServer("mlr", sharded, nodes, test, batch_size=50,
                              mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13b"):
        fl_shard_map.make_blocked_roundtrip(
            repro_torch.make_host_mesh("cpu"), {}, {},
            transport=sharded.transport)
    server = repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50,
                                   device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        server.run(1, mode="pipelined")
    assert server.round == 0


def test_step_eval_cadence_and_reset(golden_task):
    _, nodes, test = golden_task
    cfg = fl.FLConfig(num_clients=10, clients_per_round=4, local_steps=12,
                      engine="flat")
    server = repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50,
                                   device="cpu")
    init = {k: v.clone() for k, v in server.params.items()}
    accs = [float(server.step(eval_every=2)["accuracy"]) for _ in range(4)]
    assert accs[0] == accs[2] == driver.EVAL_SENTINEL
    assert accs[1] >= 0.0 and accs[3] >= 0.0
    assert abs(accs[3] - server.evaluate()) < 1e-6
    assert server.round == 4
    assert int(server.angle_state.count.sum()) == 4 * 4
    server.reset()  # the same seed draws the same initial model
    assert server.round == 0
    for k in init:
        assert torch.equal(server.params[k], init[k])


def test_vmapped_clients_match_a_loop():
    """torch.func.vmap over grad (the round's client batching) against a
    plain loop over clients, on the CNN."""
    rng = np.random.default_rng(0)
    params = small.cnn_init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.uniform(size=(3, 2, 4, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(3, 2, 4)))

    def loss(p, b):
        return small.classification_loss(small.cnn_apply, p, *b)

    deltas, losses = torch.func.vmap(
        lambda b: fl.local_update(loss, params, b, 0.05))((x, y))
    for c in range(3):
        d, l = fl.local_update(loss, params, (x[c], y[c]), 0.05)
        assert abs(float(l) - float(losses[c])) < 1e-5
        for k in d:
            scale = float(d[k].abs().max()) + 1e-30
            assert float((d[k] - deltas[k][c]).abs().max()) < 1e-4 * scale


def test_epoch_batches_depend_only_on_the_stream_and_client():
    """A client's permutation depends on (the generator's state, client
    id) only, not on who else was selected; padding is never drawn."""
    nodes = [synthetic.Dataset(np.full((n, 2), i, np.float32),
                               np.arange(n, dtype=np.int32))
             for i, n in enumerate([8, 10, 9, 10])]
    data = driver.stack_nodes(nodes, batch_size=4, device=torch.device("cpu"))
    assert data.tau == 2 and data.x.shape == (4, 10, 2)

    def draw(sel):
        gen = torch.Generator().manual_seed(7)
        return driver.epoch_batches(gen, data, torch.tensor(sel))

    xa, ya = draw([0, 2, 3])
    xb, yb = draw([3, 2])
    assert torch.equal(xa[2], xb[0]) and torch.equal(ya[1], yb[1])
    for sel_pos, c in enumerate([0, 2, 3]):
        labels = ya[sel_pos].reshape(-1)
        assert int(labels.max()) < len(nodes[c].y)  # no padding rows
        assert len(set(labels.tolist())) == labels.numel()


def test_stack_nodes_rejects_too_small_or_ragged_tau():
    mk = lambda n: synthetic.Dataset(np.zeros((n, 2), np.float32),  # noqa
                                     np.zeros(n, np.int32))
    with pytest.raises(ValueError, match="node 1"):
        driver.stack_nodes([mk(8), mk(3)], 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="disagree"):
        driver.stack_nodes([mk(8), mk(12)], 4, torch.device("cpu"))
