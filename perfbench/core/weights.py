"""Random weights from the seed, in the published checkpoints' naming.

Each model part (``perfbench/model_parts/<part>.py``) lists its leaves
``(name, shape, kind, scale)`` named as its released checkpoint names them
(timm's ViT, the Point-MAE pretraining checkpoint with its ``MAE_encoder.``
prefix, the reference's FtoF ``.pth``); ``ln``, ``bn`` and ``mlp`` below
are the lists of the layers they share.  All leaves of a model come from
one ``torch.randn`` call on the device with a seeded generator, in float32
(the served type), then one copy to the host: the port loads them through
its checkpoint path as numpy arrays, and the reference gets them back on
the device after the window.

Kinds: ``normal`` is scale * N(0, 1); ``fanin`` is N(0, 1) / sqrt(fan in);
``one`` is 1 + scale * N(0, 1) (norm scales); ``var`` is scale * exp(0.1 *
N(0, 1)) (BatchNorm running variances).  The scales are assumed (no
released checkpoint is on the machine); ``configs/*.json`` lists them under
``assumed``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.core import spec

Leaf = Tuple[str, Tuple[int, ...], str, float]


def ln(name: str, d: int) -> List[Leaf]:
    return [(f"{name}.weight", (d,), "one", 0.02), (f"{name}.bias", (d,), "normal", 0.02)]


def bn(name: str, d: int, mean_scale: float, var_scale: float) -> List[Leaf]:
    return [(f"{name}.weight", (d,), "one", 0.02), (f"{name}.bias", (d,), "normal", 0.02),
            (f"{name}.running_mean", (d,), "normal", mean_scale),
            (f"{name}.running_var", (d,), "var", var_scale)]


def mlp(name: str, d: int, h: int, kind: str) -> List[Leaf]:
    return [(f"{name}.fc1.weight", (h, d), kind, 0.02), (f"{name}.fc1.bias", (h,), "normal", 0.02),
            (f"{name}.fc2.weight", (d, h), kind, 0.02), (f"{name}.fc2.bias", (d,), "normal", 0.02)]


class Weights:
    """One model's weights: a flat float32 buffer on the host and the
    checkpoint-named views into it."""

    def __init__(self, leaves: List[Leaf], flat: np.ndarray):
        self.leaves = leaves
        self.flat = flat
        self.numpy: Dict[str, np.ndarray] = {}
        off = 0
        for name, shape, _, _ in leaves:
            n = int(np.prod(shape))
            self.numpy[name] = flat[off:off + n].reshape(shape)
            off += n

    def on(self, device) -> Dict[str, torch.Tensor]:
        """The state dict as tensors on ``device``: one copy of the buffer."""
        flat = torch.from_numpy(self.flat).to(device)
        out, off = {}, 0
        for name, shape, _, _ in self.leaves:
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].view(shape)
            off += n
        return out


def make(model: str, c: dict, seed: int, device, stream: int) -> Weights:
    """Weights of the model part ``model`` for its configuration block
    ``c`` from ``seed``; ``stream`` (the model's index in the
    configuration's ``models``) keeps the models' draws apart."""
    leaves = spec.model_part(model).leaves(c)
    total = sum(int(np.prod(s)) for _, s, _, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 7919 + stream) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    for _, shape, kind, scale in leaves:
        n = int(np.prod(shape))
        v = flat[off:off + n]
        if kind == "normal":
            v.mul_(scale)
        elif kind == "fanin":
            v.mul_(float(np.prod(shape[1:])) ** -0.5)
        elif kind == "one":
            v.mul_(scale).add_(1.0)
        elif kind == "var":
            v.mul_(0.1).exp_().mul_(scale)
        else:
            raise ValueError(f"unknown weight kind {kind!r}")
        off += n
    return Weights(leaves, flat.cpu().numpy())
