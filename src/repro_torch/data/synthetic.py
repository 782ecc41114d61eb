"""Synthetic datasets + non-IID federated partitioning (numpy only).

The port's own copy of `repro/data/synthetic.py` (the parts the FedAdp
round needs). It is numpy code and must produce IDENTICAL arrays to the
reference for the same seeds, so the two packages train on the same data.

A synthetic 10-class 28x28 image task stands in for MNIST: each class is
a smooth random template; a sample is the template under a random shift
plus pixel noise and a contrast jitter. Partitioning follows the paper:
`x-class non-IID` nodes draw all samples from x classes, IID nodes draw
uniformly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x: np.ndarray  # (N, 28, 28, 1) float32 in [0, 1]
    y: np.ndarray  # (N,) int32


def _templates(rng: np.random.Generator, num_classes: int, side: int) -> np.ndarray:
    """Smooth low-frequency class templates in [0,1]."""
    low = rng.normal(size=(num_classes, 7, 7))
    # bilinear upsample 7x7 -> side x side
    t = np.empty((num_classes, side, side), np.float32)
    xs = np.linspace(0, 6, side)
    x0 = np.clip(xs.astype(int), 0, 5)
    fx = xs - x0
    for c in range(num_classes):
        g = low[c]
        rows = g[x0][:, x0]
        rows_x1 = g[x0 + 1][:, x0]
        rows_y1 = g[x0][:, x0 + 1]
        rows_xy = g[x0 + 1][:, x0 + 1]
        t[c] = (
            rows * (1 - fx)[:, None] * (1 - fx)[None]
            + rows_x1 * fx[:, None] * (1 - fx)[None]
            + rows_y1 * (1 - fx)[:, None] * fx[None]
            + rows_xy * fx[:, None] * fx[None]
        )
    t -= t.min(axis=(1, 2), keepdims=True)
    t /= t.max(axis=(1, 2), keepdims=True) + 1e-8
    return t


def make_image_task(
    seed: int = 0,
    num_train: int = 60000,
    num_test: int = 10000,
    num_classes: int = 10,
    side: int = 28,
    shift: int = 3,
    noise: float = 0.35,
) -> tuple[Dataset, Dataset]:
    """MNIST-shaped synthetic classification task."""
    rng = np.random.default_rng(seed)
    templates = _templates(rng, num_classes, side)

    def gen(n: int, seed2: int) -> Dataset:
        r = np.random.default_rng(seed2)
        y = r.integers(0, num_classes, size=n).astype(np.int32)
        dx = r.integers(-shift, shift + 1, size=n)
        dy = r.integers(-shift, shift + 1, size=n)
        contrast = r.uniform(0.7, 1.3, size=n).astype(np.float32)
        x = np.empty((n, side, side), np.float32)
        for i in range(n):
            img = np.roll(templates[y[i]], (dx[i], dy[i]), axis=(0, 1))
            x[i] = img * contrast[i]
        x += r.normal(scale=noise, size=x.shape).astype(np.float32)
        x = np.clip(x, 0.0, 1.5) / 1.5
        return Dataset(x[..., None], y)

    return gen(num_train, seed + 1), gen(num_test, seed + 2)


# ------------------------------------------------------------ partitions


def partition_iid(rng: np.random.Generator, ds: Dataset, samples: int) -> Dataset:
    idx = rng.choice(len(ds.y), size=samples, replace=False)
    return Dataset(ds.x[idx], ds.y[idx])


def partition_xclass(
    rng: np.random.Generator, ds: Dataset, x_classes: int, samples: int,
    num_classes: int = 10,
) -> Dataset:
    """Paper's x-class non-IID node: all samples from x random classes."""
    classes = rng.choice(num_classes, size=x_classes, replace=False)
    pool = np.flatnonzero(np.isin(ds.y, classes))
    idx = rng.choice(pool, size=samples, replace=len(pool) < samples)
    return Dataset(ds.x[idx], ds.y[idx])


def make_federated(
    train: Dataset,
    node_spec: list,  # e.g. [("iid", None)] * 5 + [("xclass", 1)] * 5
    samples_per_node: int = 600,
    seed: int = 0,
) -> list[Dataset]:
    rng = np.random.default_rng(seed)
    nodes = []
    for kind, x in node_spec:
        if kind == "iid":
            nodes.append(partition_iid(rng, train, samples_per_node))
        elif kind == "xclass":
            nodes.append(partition_xclass(rng, train, x, samples_per_node))
        else:
            raise ValueError(kind)
    return nodes
