"""Random weights from the seed, in the published checkpoints' naming.

Each model is a list of leaves ``(name, shape, kind, scale)`` named as its
released checkpoint names them: timm's ViT, the Point-MAE pretraining
checkpoint (``MAE_encoder.`` prefix), the reference's FtoF ``.pth``.  All
leaves of a model come from one ``torch.randn`` call on the device with a
seeded generator, in float32 (the served type), then one copy to the host:
the port loads them through its checkpoint path as numpy arrays, and the
reference gets them back on the device after the window.

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

Leaf = Tuple[str, Tuple[int, ...], str, float]


def vit_leaves(c: dict) -> List[Leaf]:
    d, p, n = c["embed_dim"], c["patch_size"], (c["img_size"] // c["patch_size"]) ** 2
    h = int(d * c["mlp_ratio"])
    out: List[Leaf] = [
        ("patch_embed.proj.weight", (d, 3, p, p), "normal", 0.02),
        ("patch_embed.proj.bias", (d,), "normal", 0.02),
        ("cls_token", (1, 1, d), "normal", 0.02),
        ("pos_embed", (1, n + 1, d), "normal", 0.02)]
    for i in range(c["depth"]):
        t = f"blocks.{i}"
        out += _ln(f"{t}.norm1", d) + [
            (f"{t}.attn.qkv.weight", (3 * d, d), "normal", 0.02)]
        if c["qkv_bias"]:
            out.append((f"{t}.attn.qkv.bias", (3 * d,), "normal", 0.02))
        out += [(f"{t}.attn.proj.weight", (d, d), "normal", 0.02),
                (f"{t}.attn.proj.bias", (d,), "normal", 0.02)]
        out += _ln(f"{t}.norm2", d) + _mlp(f"{t}.mlp", d, h, "normal")
    return out + _ln("norm", d)


def point_mae_leaves(c: dict, prefix: str = "MAE_encoder.") -> List[Leaf]:
    t, e = c["trans_dim"], c["encoder_dims"]
    h = int(t * c["mlp_ratio"])
    enc = "encoder"
    out: List[Leaf] = [
        (f"{enc}.first_conv.0.weight", (128, 3, 1), "fanin", 1.0),
        (f"{enc}.first_conv.0.bias", (128,), "normal", c["first_bn"]["bias"])]
    out += _bn(f"{enc}.first_conv.1", 128, c["first_bn"]["mean"], c["first_bn"]["var"])
    out += [(f"{enc}.first_conv.3.weight", (256, 128, 1), "fanin", 1.0),
            (f"{enc}.first_conv.3.bias", (256,), "normal", 0.02),
            (f"{enc}.second_conv.0.weight", (512, 512, 1), "fanin", 1.0),
            (f"{enc}.second_conv.0.bias", (512,), "normal", 0.02)]
    out += _bn(f"{enc}.second_conv.1", 512, 0.02, 1.0)
    out += [(f"{enc}.second_conv.3.weight", (e, 512, 1), "fanin", 1.0),
            (f"{enc}.second_conv.3.bias", (e,), "normal", 0.02),
            ("pos_embed.0.weight", (128, 3), "fanin", 1.0),
            ("pos_embed.0.bias", (128,), "normal", 0.02),
            ("pos_embed.2.weight", (t, 128), "fanin", 1.0),
            ("pos_embed.2.bias", (t,), "normal", 0.02)]
    for i in range(c["depth"]):
        b = f"blocks.blocks.{i}"
        out += _ln(f"{b}.norm1", t) + [
            (f"{b}.attn.qkv.weight", (3 * t, t), "normal", 0.02),
            (f"{b}.attn.proj.weight", (t, t), "normal", 0.02),
            (f"{b}.attn.proj.bias", (t,), "normal", 0.02)]
        out += _ln(f"{b}.norm2", t) + _mlp(f"{b}.mlp", t, h, "normal")
    out += _ln("norm", t)
    return [(prefix + n, s, k, sc) for n, s, k, sc in out]


def ftof_mlp_leaves(c: dict) -> List[Leaf]:
    """The reference's ``HallucinationCrossModalityNetwork`` state dict
    (``mlp_depth`` 1): both directions, although a line with one camera
    runs one of them."""
    out: List[Leaf] = []
    for side, din, dout in (("xyz", c["xyz_dim"], c["rgb_dim"]),
                            ("rgb", c["rgb_dim"], c["xyz_dim"])):
        h = c["hidden"]
        out += _ln(f"{side}_norm", din)
        m = f"{side}_mlp.mlp_module.0"
        out += [(f"{m}.fc1.weight", (h, din), "fanin", 1.0),
                (f"{m}.fc1.bias", (h,), "normal", 0.02),
                (f"{m}.fc2.weight", (h, h), "fanin", 1.0),
                (f"{m}.fc2.bias", (h,), "normal", 0.02),
                (f"{m}.fc3.weight", (dout, h), "fanin", 1.0),
                (f"{m}.fc3.bias", (dout,), "normal", 0.02)]
    return out


def _ln(name: str, d: int) -> List[Leaf]:
    return [(f"{name}.weight", (d,), "one", 0.02), (f"{name}.bias", (d,), "normal", 0.02)]


def _bn(name: str, d: int, mean_scale: float, var_scale: float) -> List[Leaf]:
    return [(f"{name}.weight", (d,), "one", 0.02), (f"{name}.bias", (d,), "normal", 0.02),
            (f"{name}.running_mean", (d,), "normal", mean_scale),
            (f"{name}.running_var", (d,), "var", var_scale)]


def _mlp(name: str, d: int, h: int, kind: str) -> List[Leaf]:
    return [(f"{name}.fc1.weight", (h, d), kind, 0.02), (f"{name}.fc1.bias", (h,), "normal", 0.02),
            (f"{name}.fc2.weight", (d, h), kind, 0.02), (f"{name}.fc2.bias", (d,), "normal", 0.02)]


LEAVES = {"vit": vit_leaves, "point_mae": point_mae_leaves, "ftof_mlp": ftof_mlp_leaves}


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
    """Weights of ``model`` (a key of ``LEAVES``) for configuration part
    ``c`` from ``seed``; ``stream`` keeps the models' draws apart."""
    leaves = LEAVES[model](c)
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
