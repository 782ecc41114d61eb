"""The loss and its gradients of the port's other model families
against the JAX package: `transformer.loss_fn` under
`torch.func.grad_and_value` against `jax.value_and_grad` of the
reference's, for every variant of tests/test_torch_families.py (whose
helpers and params this file shares), on the same numpy tokens and stub
embeddings, and the chunked loss (`cfg.loss_chunk`) through
`hidden_forward` after a vision prefix, with the encoder and with the
MoE aux. The reference's `tests/test_arch_smoke.py` trains these
families; the port has no federated trainer for them yet.

Tolerances: 1e-5 (tests/test_torch_lm_train.py), 2e-5 where flash runs
(the f32 kernel's plain version, whose backward is the reference's
recompute), and 2e-2 for the two variants that store a tensor in bf16
(see tests/test_torch_families.py: the loss differs by 1.2e-4 for
jamba's bf16 streams, 1.2e-5 for the bf16 MoE combine).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro_torch.models import transformer as ttr
from test_torch_families import (FLASH_LOSS_TOL, LOSS_TOL, VARIANTS,
                                 _close, _inputs, _jbatch, _runs_flash,
                                 _setup, _tbatch, _tree_close, tol_for)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread: when several test processes share
    the CPU, torch's default pool oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax(variant):
    jcfg, cfg, jparams, params = _setup(variant)
    batch, _, _ = _inputs(cfg)
    tol = tol_for(variant, FLASH_LOSS_TOL if _runs_flash(cfg)
                  else LOSS_TOL)
    want_loss, want = jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jcfg, _jbatch(batch)))(jparams)
    got, loss = torch.func.grad_and_value(
        lambda p: ttr.loss_fn(p, cfg, _tbatch(batch)))(params)
    _close(loss, want_loss, "loss", tol)
    _tree_close(got, jax.tree.map(np.asarray, want), "grad", tol)


@pytest.mark.parametrize("variant", ["qwen2-vl-2b", "whisper-small",
                                     "deepseek-v2-lite-16b"])
def test_chunked_loss_matches_jax(variant):
    """`cfg.loss_chunk` = 24 (chunks that need padding): the loss through
    `hidden_forward`, after the vision prefix's text offset, with the
    encoder, and with the MoE aux, against the reference's."""
    jcfg, cfg, jparams, params = _setup(variant)
    jcfg = dataclasses.replace(jcfg, loss_chunk=24)
    cfg = dataclasses.replace(cfg, loss_chunk=24)
    batch, _, _ = _inputs(cfg)
    want = jtr.loss_fn(jparams, jcfg, _jbatch(batch))
    with torch.no_grad():
        got = ttr.loss_fn(params, cfg, _tbatch(batch))
    _close(got, want, "chunked loss",
           FLASH_LOSS_TOL if _runs_flash(cfg) else LOSS_TOL)
