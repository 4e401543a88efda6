"""The paper's own experiment models (supplementary C.1; port of
``repro.models.vision``):

* FC      -- one hidden layer of width 128 (D=101,770 on 28x28x1 inputs,
             D=394,634 on 32x32x3)
* CNN     -- conv(3x3,32) pool conv(3x3,64) pool conv(3x3,64) dense(64)
             (D=93,322 on MNIST shapes, D=122,570 on CIFAR shapes)
* ResNet8 -- 8-layer residual CNN (77,706 on CIFAR shapes)

Parameters are flat ``{"fc1/w": ...}`` maps in the reference's leaf
order, with its names and shapes: dense weights (n_in, n_out), conv
weights HWIO (h, w, c_in, c_out), so the RBD plan and its seeds follow
the reference's.  Inputs are NHWC (B, H, W, C) as in the reference;
``apply`` permutes to torch's NCHW / OIHW inside.  Convolutions pad as
XLA does: ``"SAME"`` pads ``total = max((ceil(n / s) - 1) * s + k - n,
0)`` with ``total // 2`` before and the rest after (at stride 2 on an even
input, 0 before and 1 after a 3x3 kernel), pooling is 2x2 ``"VALID"``.
The init draws from a ``torch.Generator`` with the reference's scales
(its numbers differ: the reference draws from jax.random).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.compartments import leaf_order
from repro_torch.models.registry import resolve_device


def _ordered(p: dict) -> dict:
    return {k: p[k] for k in leaf_order(p)}


def _dense(gen, name, n_in, n_out, device) -> dict:
    w = torch.randn((n_in, n_out), generator=gen, device=device)
    return {f"{name}/w": w * float(np.sqrt(2.0 / n_in)),
            f"{name}/b": torch.zeros((n_out,), device=device)}


def _conv(gen, name, h, w, c_in, c_out, device) -> dict:
    x = torch.randn((h, w, c_in, c_out), generator=gen, device=device)
    return {f"{name}/w": x * float(np.sqrt(2.0 / (h * w * c_in))),
            f"{name}/b": torch.zeros((c_out,), device=device)}


def _generator(seed: int, device):
    device = resolve_device(device)
    return torch.Generator(device=device).manual_seed(seed), device


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _apply_conv(p: dict, name: str, x, *, stride=1, padding="VALID"):
    """x: (B, C, H, W) -> (B, C_out, H', W'); the conv of HWIO leaf
    ``{name}/w`` plus ``{name}/b``."""
    w = p[f"{name}/w"]
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        top, bottom = _same_pads(x.shape[2], kh, stride)
        left, right = _same_pads(x.shape[3], kw, stride)
        x = F.pad(x, (left, right, top, bottom))
    out = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)
    return out + p[f"{name}/b"][:, None, None]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _linear(p: dict, name: str, x):
    return x @ p[f"{name}/w"] + p[f"{name}/b"]


# --------------------------------------------------------------------------
# FC
# --------------------------------------------------------------------------


def fc_init(seed: int = 0, input_shape=(28, 28, 1), n_classes=10, width=128,
            *, device="cuda") -> dict:
    gen, device = _generator(seed, device)
    d_in = int(np.prod(input_shape))
    return _ordered({**_dense(gen, "fc1", d_in, width, device),
                     **_dense(gen, "fc2", width, n_classes, device)})


def fc_apply(params: dict, x):
    x = x.reshape(x.shape[0], -1)
    return _linear(params, "fc2", F.relu(_linear(params, "fc1", x)))


# --------------------------------------------------------------------------
# CNN (paper C.1)
# --------------------------------------------------------------------------


def cnn_init(seed: int = 0, input_shape=(28, 28, 1), n_classes=10, *,
             device="cuda") -> dict:
    gen, device = _generator(seed, device)
    c_in = input_shape[-1]
    h, w = input_shape[:2]
    # conv valid 3x3 -> pool2 -> conv -> pool2 -> conv
    h1, w1 = (h - 2) // 2, (w - 2) // 2
    h2, w2 = (h1 - 2) // 2, (w1 - 2) // 2
    h3, w3 = h2 - 2, w2 - 2
    return _ordered({**_conv(gen, "conv1", 3, 3, c_in, 32, device),
                     **_conv(gen, "conv2", 3, 3, 32, 64, device),
                     **_conv(gen, "conv3", 3, 3, 64, 64, device),
                     **_dense(gen, "fc1", h3 * w3 * 64, 64, device),
                     **_dense(gen, "fc2", 64, n_classes, device)})


def cnn_apply(params: dict, x):
    x = _nchw(x)
    x = F.max_pool2d(F.relu(_apply_conv(params, "conv1", x)), 2)
    x = F.max_pool2d(F.relu(_apply_conv(params, "conv2", x)), 2)
    x = F.relu(_apply_conv(params, "conv3", x))
    # the reference flattens NHWC: fc1's rows are (h, w, c) in that order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return _linear(params, "fc2", F.relu(_linear(params, "fc1", x)))


# --------------------------------------------------------------------------
# ResNet-8 (3 residual blocks of 2 convs + stem + head)
# --------------------------------------------------------------------------


def resnet8_init(seed: int = 0, input_shape=(32, 32, 3), n_classes=10,
                 width=16, *, device="cuda") -> dict:
    gen, device = _generator(seed, device)
    c = width
    p = _conv(gen, "stem", 3, 3, input_shape[-1], c, device)
    for i, (cin, cout) in enumerate([(c, c), (c, 2 * c), (2 * c, 4 * c)]):
        p.update(_conv(gen, f"block{i}_conv1", 3, 3, cin, cout, device))
        p.update(_conv(gen, f"block{i}_conv2", 3, 3, cout, cout, device))
        if cin != cout:
            p.update(_conv(gen, f"block{i}_proj", 1, 1, cin, cout, device))
    p.update(_dense(gen, "head", 4 * c, n_classes, device))
    return _ordered(p)


def resnet8_apply(params: dict, x):
    x = F.relu(_apply_conv(params, "stem", _nchw(x), padding="SAME"))
    for i in range(3):
        stride = 1 if i == 0 else 2
        h = F.relu(_apply_conv(params, f"block{i}_conv1", x, stride=stride,
                               padding="SAME"))
        h = _apply_conv(params, f"block{i}_conv2", h, padding="SAME")
        sc = x
        if f"block{i}_proj/w" in params:
            sc = _apply_conv(params, f"block{i}_proj", x, stride=stride,
                             padding="SAME")
        x = F.relu(h + sc)
    return _linear(params, "head", x.mean(dim=(2, 3)))


MODELS = {
    "fc": (fc_init, fc_apply),
    "cnn": (cnn_init, cnn_apply),
    "resnet8": (resnet8_init, resnet8_apply),
}


def get_vision_model(name: str):
    """(init, apply) of ``name``: ``init(seed, input_shape, ..., device=)``
    -> a parameter map, ``apply(params, x (B, H, W, C))`` -> logits."""
    return MODELS[name]


def count_params(params: dict) -> int:
    return sum(x.numel() for x in params.values())
