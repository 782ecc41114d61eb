"""Tree checkpointing: nested-dict trees <-> single .npz files, plus a
checkpoint-directory layer (atomic write-then-rename, a `latest` pointer,
retention) for kill/resume of a running scan.

The port's counterpart of `repro/checkpoint/io.py`, with its layout:
paths are flattened with '/' separators, and `core.fl.state_to_tree` /
`state_from_tree` are the RoundState codec, so an archive of the same
state written by either package holds the same keys, dtypes and bytes,
the generator entry apart. Leaf encodings that numpy cannot round-trip
natively get a name tag:

* bfloat16         -> its bits, stored as uint16, name suffixed
                      ``__bf16__``
* generator states -> `GeneratorState`: `torch.Generator.get_state()`'s
                      uint8 bytes, name suffixed ``__gen:<device type>__``
                      (the JAX package stores its typed PRNG key under
                      ``__key:<impl>__`` in this place)
* None leaves      -> zero-byte sentinel named ``<path>__none__`` (an
                      optional RoundState field that is off survives a
                      round trip as None)
* empty dicts      -> zero-byte sentinel named ``<path>__empty__``

Dict keys containing the ``/`` separator are rejected. `load` returns
CPU tensors (and `GeneratorState`s); the codec moves them to a device.
"""
from __future__ import annotations

import os
import re
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

Tree = Any
_BF16_TAG = "__bf16__"
_NONE_TAG = "__none__"
_EMPTY_TAG = "__empty__"
_GEN_TAG_RE = re.compile(r"__gen:([A-Za-z0-9_]+)__$")

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")
_LATEST = "latest"


class GeneratorState(NamedTuple):
    """A `torch.Generator`'s state, detached from the generator: the
    device type it belongs to ("cpu" or "cuda") and `get_state()`'s
    uint8 bytes (a CPU tensor)."""

    device_type: str
    state: torch.Tensor

    @classmethod
    def of(cls, gen: torch.Generator) -> "GeneratorState":
        return cls(gen.device.type, gen.get_state())

    def generator(self, device) -> torch.Generator:
        """A new generator on `device` that continues this stream.
        Raises ValueError when `device` is of another type: a stream of
        one device type does not continue on another."""
        device = torch.device(device)
        if device.type != self.device_type:
            raise ValueError(
                f"the checkpoint's generator state is a {self.device_type!r} "
                f"generator's and cannot continue on a {device.type!r} "
                f"device; restore onto {self.device_type!r}")
        gen = torch.Generator(device=device)
        gen.set_state(self.state)
        return gen


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree: Tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        if not tree and prefix:
            out[prefix[:-1] + _EMPTY_TAG] = np.zeros((0,), np.uint8)
            return out
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(
                    f"checkpoint path component {k!r} (under "
                    f"{prefix!r}) contains the '/' separator — it would "
                    "corrupt the flattened key; rename the field")
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    key = prefix[:-1]
    if tree is None:
        out[key + _NONE_TAG] = np.zeros((0,), np.uint8)
    elif isinstance(tree, GeneratorState):
        out[f"{key}__gen:{tree.device_type}__"] = _array(tree.state)
    elif isinstance(tree, torch.Tensor):
        out[key + (_BF16_TAG if tree.dtype == torch.bfloat16 else "")] = \
            _array(tree)
    else:
        arr = np.asarray(tree)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
            out[key + _BF16_TAG] = arr.view(np.uint16)
        else:
            out[key] = arr
    return out


def _unflatten(flat: dict) -> Tree:
    tree: dict = {}
    for key, arr in flat.items():
        value: Any
        m = _GEN_TAG_RE.search(key)
        if m is not None:
            key = key[: m.start()]
            value = GeneratorState(m.group(1),
                                   torch.from_numpy(arr.astype(np.uint8)))
        elif key.endswith(_NONE_TAG):
            key = key[: -len(_NONE_TAG)]
            value = None
        elif key.endswith(_EMPTY_TAG):
            key = key[: -len(_EMPTY_TAG)]
            value = {}
        elif key.endswith(_BF16_TAG):
            key = key[: -len(_BF16_TAG)]
            value = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            value = torch.from_numpy(arr)
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _norm_path(path: str) -> str:
    """np.savez appends '.npz' when the name lacks it; normalize BOTH
    save and load onto the suffixed name so `load(p)` always finds what
    `save(p)` wrote."""
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Tree) -> str:
    """Atomically write `tree` to `path` (suffix-normalized to .npz).

    The archive is written to a sibling temp file and `os.replace`d into
    place, so a writer killed mid-save never leaves a torn checkpoint
    under the final name. Returns the normalized path."""
    path = _norm_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load(path: str) -> Tree:
    """The tree `save` wrote, with CPU tensors for its arrays."""
    with np.load(_norm_path(path)) as z:
        return _unflatten({k: z[k] for k in z.files})


# ------------------------------------------------ checkpoint directories


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")


def list_checkpoints(ckpt_dir: str) -> "list[tuple[int, str]]":
    """(step, path) pairs found in `ckpt_dir`, ascending by step."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    keep: int = 3) -> str:
    """Durable snapshot at `step`: atomic archive write, then the
    `latest` pointer is atomically swung to it, then retention deletes
    all but the newest `keep` archives (the pointer target is always
    among the survivors; keep=0 keeps all). Returns the archive path."""
    path = save(checkpoint_path(ckpt_dir, step), tree)
    tmp = os.path.join(ckpt_dir, f"{_LATEST}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(os.path.basename(path) + "\n")
    os.replace(tmp, os.path.join(ckpt_dir, _LATEST))
    if keep > 0:
        for _, old in list_checkpoints(ckpt_dir)[:-keep]:
            if os.path.abspath(old) != os.path.abspath(path):
                os.remove(old)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the newest complete checkpoint, or None.

    Trusts the `latest` pointer when it resolves; falls back to the
    highest-step archive on disk (a crash can kill the writer between
    the archive rename and the pointer swing)."""
    ptr = os.path.join(ckpt_dir, _LATEST)
    if os.path.isfile(ptr):
        with open(ptr) as f:
            cand = os.path.join(ckpt_dir, f.read().strip())
        if os.path.isfile(cand):
            return cand
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def load_latest(ckpt_dir: str) -> "Optional[tuple[int, Tree]]":
    """(step, tree) of the newest checkpoint in `ckpt_dir`, or None."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    step = int(_CKPT_RE.match(os.path.basename(path)).group(1))
    return step, load(path)
