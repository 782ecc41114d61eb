"""The port's examples (`examples/torch_*.py`) run end to end on the CPU.

Each example's `main(argv)` runs with `--device cpu` at a tiny size, its
outputs under pytest's `tmp_path`: the two FedAdp image drivers for 2
rounds, the serving demo on a reduced dense architecture and, with
`python -m repro_torch.launch.serve`, on each of the other families
(their greedy ids against the JAX package's `decode_step` loop at
positions P + T + i), and federated LM training, whose checkpoint must
restore the final RoundState, and whose round on the flash attention
path and the flat engine must equal the one on xla and tree. The
examples, like the port, import no jax, and without `--device` they run
on CUDA or raise.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.checkpoint import io as ckpt
from repro_torch.core import treemath
from test_torch_families import NEW_FAMILIES

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
NAMES = ("torch_quickstart", "torch_fedadp_noniid", "torch_serve_decode",
         "torch_fl_lm_train")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    # when several test processes share the CPU, torch's default pool
    # oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_repro(name):
    with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)", src,
                         re.MULTILINE)
    assert "def main(argv=None)" in src and '"--device"' in src


def test_quickstart_two_rounds(capsys):
    _load("torch_quickstart").main(["--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    for method in ("fedavg", "fedadp"):
        assert re.search(rf"{method} *: rounds to 85% accuracy = ", out), out


def test_fedadp_noniid_writes_its_json(tmp_path, capsys):
    import json

    _load("torch_fedadp_noniid").main(
        ["--model", "mlr", "--rounds", "2", "--out", str(tmp_path),
         "--device", "cpu"])
    path = tmp_path / "fedadp_mlr_5iid+5non1.json"
    assert f"wrote {path}" in capsys.readouterr().out
    rec = json.loads(path.read_text())
    for method in ("fedavg", "fedadp"):
        assert len(rec[method]["loss"]) == 2
        assert len(rec[method]["accuracy"]) == 1  # eval every 2 rounds
        assert all(np.isfinite(rec[method]["loss"]))


def test_serve_decode_dense(capsys):
    _load("torch_serve_decode").main(
        ["--arch", "gemma-2b", "--batch", "2", "--prompt-len", "16",
         "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[gemma-2b-smoke] prefill B=2 T=16" in out
    ids = re.search(r"sample token ids: \[(.*)\]", out).group(1).split(",")
    assert len(ids) == 3




def _jax_greedy(arch, params, tokens, steps):
    """The JAX package's greedy loop on the port's params: its prefill
    with zero stub embeddings, then its `decode_step` at positions
    P + T + i."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.models import transformer as jtr
    from repro_torch import convert

    cfg = jreg.smoke(arch)
    jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(params))
    b, t = tokens.shape
    batch = {"tokens": jnp.asarray(tokens.numpy().astype(np.int32))}
    if cfg.vision_prefix:
        batch["vision_embeds"] = jnp.zeros((b, cfg.vision_prefix,
                                            cfg.d_model), cfg.jdtype)
    if cfg.encoder_layers:
        batch["enc_embeds"] = jnp.zeros((b, cfg.encoder_len, cfg.d_model),
                                        cfg.jdtype)
    start = cfg.vision_prefix + t
    logits, _, cache = jtr.forward(jparams, cfg, batch, mode="prefill",
                                   max_len=start + steps)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = jtr.decode_step(jparams, cfg, tok, cache,
                                        jnp.int32(start + i), {})
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def _ids(text):
    return [int(x) for x in re.search(r"sample token ids: \[(.*)\]",
                                      text).group(1).split(",")]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_decode_and_launcher_run_the_other_families(arch, capsys):
    """The example and `python -m repro_torch.launch.serve` on each new
    family (reduced, B = 2, T = 16, 3 steps): their greedy ids are
    `generate`'s on the same seeded params and tokens, which equal a
    greedy loop over the JAX package's `decode_step` at P + T + i."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "16",
            "--steps", "3", "--device", "cpu"]
    _load("torch_serve_decode").main(argv)
    text = capsys.readouterr().out
    assert f"[{arch}-smoke] prefill B=2 T=16" in text
    serve.main(argv)
    launched = capsys.readouterr().out
    assert f"[{arch}-smoke on cpu, attention=xla] B=2 T=16" in launched

    cfg = registry.smoke(arch)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    ids = serve.generate(params, cfg, tokens, 3,
                         extras=serve.stub_extras(cfg, 2, "cpu"))
    want = _jax_greedy(arch, params, tokens, 3)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert _ids(text) == _ids(launched) == want[0].tolist()


def test_fl_lm_train_saves_the_final_state(tmp_path, capsys):
    ex = _load("torch_fl_lm_train")
    out = tmp_path / "fl_lm.npz"
    ex.main(["--rounds", "2", "--clients", "3", "--batch", "2", "--seq",
             "64", "--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "model fl-lm-small: 6.0M params; K=3 tau=2 B=2 T=64" in text
    losses = [float(x) for x in re.findall(r"round +\d+ loss ([0-9.]+)",
                                           text)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert f"checkpoint -> {out}" in text

    # the saved RoundState is the run's: replay the two rounds by hand
    cfg = ex.model_config("small")
    fl = repro_torch.FLConfig(num_clients=3, clients_per_round=3,
                              local_steps=2, base_lr=0.05, lr_decay=0.999)
    state = repro_torch.state_from_tree(fl, ckpt.load(str(out)),
                                        device="cpu")
    assert int(state.round) == 2
    params = ex.transformer.init_params(torch.Generator().manual_seed(0),
                                        cfg)
    want = repro_torch.init_round_state(fl, params)
    round_fn = ex.make_round(cfg, fl)
    for r in range(2):
        want, _ = round_fn(want, ex.round_tokens(r, 3, 2, 2, 64,
                                                 cfg.vocab_size, "cpu"),
                           torch.arange(3), torch.ones(3))
    for a, b in zip(treemath.tree_leaves(state.params),
                    treemath.tree_leaves(want.params)):
        assert torch.equal(a, b)


def test_fl_lm_train_round_on_the_kernel_path():
    """The example's round as chip_smoke.py runs it: flash attention and
    the flat engine, against the xla attention and the tree engine."""
    ex = _load("torch_fl_lm_train")
    kw = dict(num_clients=3, clients_per_round=3, local_steps=2,
              base_lr=0.05, lr_decay=0.999)
    params = ex.transformer.init_params(torch.Generator().manual_seed(0),
                                        ex.model_config("small"))
    batches = ex.round_tokens(0, 3, 2, 2, 64, 8192, "cpu")
    out = {}
    for impl, engine in (("xla", "tree"), ("flash", "flat")):
        fl = repro_torch.FLConfig(engine=engine, **kw)
        out[impl] = ex.make_round(ex.model_config("small", impl), fl)(
            repro_torch.init_round_state(fl, params), batches,
            torch.arange(3), torch.ones(3))
    for a, b in zip(treemath.tree_leaves(out["flash"][0].params),
                    treemath.tree_leaves(out["xla"][0].params)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out["flash"][1]["weights"],
                               out["xla"][1]["weights"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        _load(name).main([])
