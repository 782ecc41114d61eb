"""The paper's own evaluation models (Section V), functional torch.

The counterpart of `repro/models/small.py`. Params are `dict[str,
Tensor]` in the JAX package's layout, so weights carry across as plain
copies and the raveled buffers compare element for element:

* MLR: multinomial logistic regression, w (784, C), b (C,).
* CNN: 5x5x32 conv > 2x2 maxpool > 5x5x64 conv > 2x2 maxpool >
  FC(3136->512) > FC(512->10); 1,663,370 parameters. Conv weights are
  HWIO, FC weights (in, out), inputs NHWC (B, 28, 28, 1); `cnn_apply`
  permutes to torch's OIHW / NCHW internally and back to NHWC before the
  flatten that feeds FC1, whose rows are in (h, w, c) order.

Init functions draw from an explicit `torch.Generator` and return
tensors on the generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mlr_init(gen: torch.Generator, num_classes: int = 10,
             side: int = 28) -> dict:
    d = side * side
    return {
        "w": torch.randn((d, num_classes), generator=gen,
                         device=gen.device) * 0.01,
        "b": torch.zeros(num_classes, device=gen.device),
    }


def mlr_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) @ params["w"] + params["b"]


def cnn_init(gen: torch.Generator, num_classes: int = 10) -> dict:
    dev = gen.device

    def conv(kh, kw, cin, cout):
        return (torch.randn((kh, kw, cin, cout), generator=gen, device=dev)
                / math.sqrt(kh * kw * cin))

    def fc(a, b):
        return torch.randn((a, b), generator=gen, device=dev) / math.sqrt(a)

    return {
        "c1": conv(5, 5, 1, 32), "b1": torch.zeros(32, device=dev),
        "c2": conv(5, 5, 32, 64), "b2": torch.zeros(64, device=dev),
        "f1": fc(3136, 512), "fb1": torch.zeros(512, device=dev),
        "f2": fc(512, num_classes), "fb2": torch.zeros(num_classes,
                                                       device=dev),
    }


def _conv_same(h: torch.Tensor, w_hwio: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """NCHW conv with an HWIO weight, stride 1, "SAME" padding (odd k)."""
    pad = w_hwio.shape[0] // 2
    return F.conv2d(h, w_hwio.permute(3, 2, 0, 1), b, padding=pad)


def cnn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 28, 28, 1) NHWC -> logits (B, 10)."""
    h = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
    h = F.max_pool2d(F.relu(_conv_same(h, params["c1"], params["b1"])), 2)
    h = F.max_pool2d(F.relu(_conv_same(h, params["c2"], params["b2"])), 2)
    # back to NHWC before flattening: FC1's rows are in (h, w, c) order
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["f1"] + params["fb1"])
    return h @ params["f2"] + params["fb2"]


MODELS = {
    "mlr": (mlr_init, mlr_apply),
    "cnn": (cnn_init, cnn_apply),
}


def classification_loss(apply_fn, params, x, y) -> torch.Tensor:
    """Mean softmax cross-entropy; y holds integer labels."""
    logits = apply_fn(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.to(torch.int64)[:, None])[:, 0]
    return torch.mean(logz - ll)


def accuracy(apply_fn, params, x, y, batch: int = 2048) -> float:
    """Fraction of (x, y) classified correctly; numpy or tensor inputs,
    evaluated on the params' device."""
    dev = next(iter(params.values())).device
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    correct = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            logits = apply_fn(params, x[i:i + batch])
            correct += int(torch.sum(torch.argmax(logits, -1)
                                     == y[i:i + batch]))
    return correct / x.shape[0]
