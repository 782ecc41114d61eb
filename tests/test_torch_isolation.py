"""The port stands alone: it imports neither jax nor the JAX package.

`import repro_torch` (and every module of it) in a fresh interpreter must
leave `jax` and `repro` out of `sys.modules`, and no source file of the
port nor the chip scripts (chip_smoke.py, chip_ab.py) may import them.
Importing the port builds no kernel. chip_smoke.py turns TF32 off for
matmuls and cuDNN convs, and both scripts refuse to run without a GPU.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
AB = os.path.join(ROOT, "chip_ab.py")



def _modules():
    """Every module of the port, found by walking its source tree, so a
    new module is checked without editing a list."""
    mods = []
    for dirpath, _, files in os.walk(PKG):
        rel = os.path.relpath(dirpath, os.path.join(ROOT, "src"))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            parts = rel.split(os.sep)
            if f != "__init__.py":
                parts.append(f[:-3])
            mods.append(".".join(parts))
    return sorted(mods)


MODULES = _modules()

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))", re.MULTILINE)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield SMOKE
    yield AB


def test_module_walk_finds_every_module():
    for mod in ("repro_torch", "repro_torch.core.buffer",
                "repro_torch.transport.downlink",
                "repro_torch.checkpoint.io", "repro_torch.telemetry.sinks",
                "repro_torch.launch.serve", "repro_torch.launch.steps",
                "repro_torch.launch.train", "repro_torch.launch.dryrun",
                "repro_torch.launch.optrace", "repro_torch.models.sharding",
                "repro_torch.models.recompute",
                "repro_torch.configs.shapes"):
        assert mod in MODULES, mod
    assert len(MODULES) >= 45


def test_import_leaves_jax_and_repro_out():
    prog = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "from repro_torch.kernels import _build\n"
              "assert not _build._LIBS, 'importing built a kernel'\n"
              "print('LEAKED', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout


def test_no_source_imports_jax_or_repro():
    files = list(_sources())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            text = f.read()
        hit = _FORBIDDEN.search(text)
        assert hit is None, f"{path}: {hit.group(0).strip()}"


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import repro",
                "from repro.core import fl", "  import jax.numpy as jnp"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import fl",
               "# see repro/core/fl.py", "import jaxlib_free"):
        assert not _FORBIDDEN.search(ok), ok


def test_chip_smoke_turns_tf32_off():
    with open(SMOKE) as f:
        text = f.read()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in text
    assert "torch.backends.cudnn.allow_tf32 = False" in text


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs the scripts "
                    "only where they must refuse: without a GPU")
@pytest.mark.parametrize("argv", [[SMOKE], [AB, "--alt", ROOT]])
def test_chip_scripts_refuse_without_a_gpu(argv):
    out = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "no CUDA device" in out.stderr and not out.stdout.strip()
