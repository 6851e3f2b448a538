"""Point-MAE's encoder as its pretraining checkpoint releases it (the
``MAE_encoder.`` prefix): the xyz backbone
(``perfbench/reference/point_mae.py``), loaded into the port's
``DualBackbone.point``."""

from __future__ import annotations

import dataclasses
from typing import List

from perfbench.core.weights import Leaf, bn, ln, mlp
from perfbench.reference import point_mae as reference

ROLE = "xyz"
CHECKPOINT_PREFIX = "MAE_encoder."
# first_bn: the assumed scales of the first BatchNorm's statistics;
# point_capacity: the capacity of the compacted cloud the traffic hands over
NOT_WIDTHS = ("source", "first_bn", "point_capacity")


def leaves(c: dict) -> List[Leaf]:
    t, e = c["trans_dim"], c["encoder_dims"]
    h = int(t * c["mlp_ratio"])
    enc = "encoder"
    out: List[Leaf] = [
        (f"{enc}.first_conv.0.weight", (128, 3, 1), "fanin", 1.0),
        (f"{enc}.first_conv.0.bias", (128,), "normal", c["first_bn"]["bias"])]
    out += bn(f"{enc}.first_conv.1", 128, c["first_bn"]["mean"], c["first_bn"]["var"])
    out += [(f"{enc}.first_conv.3.weight", (256, 128, 1), "fanin", 1.0),
            (f"{enc}.first_conv.3.bias", (256,), "normal", 0.02),
            (f"{enc}.second_conv.0.weight", (512, 512, 1), "fanin", 1.0),
            (f"{enc}.second_conv.0.bias", (512,), "normal", 0.02)]
    out += bn(f"{enc}.second_conv.1", 512, 0.02, 1.0)
    out += [(f"{enc}.second_conv.3.weight", (e, 512, 1), "fanin", 1.0),
            (f"{enc}.second_conv.3.bias", (e,), "normal", 0.02),
            ("pos_embed.0.weight", (128, 3), "fanin", 1.0),
            ("pos_embed.0.bias", (128,), "normal", 0.02),
            ("pos_embed.2.weight", (t, 128), "fanin", 1.0),
            ("pos_embed.2.bias", (t,), "normal", 0.02)]
    for i in range(c["depth"]):
        b = f"blocks.blocks.{i}"
        out += ln(f"{b}.norm1", t) + [
            (f"{b}.attn.qkv.weight", (3 * t, t), "normal", 0.02),
            (f"{b}.attn.proj.weight", (t, t), "normal", 0.02),
            (f"{b}.attn.proj.bias", (t,), "normal", 0.02)]
        out += ln(f"{b}.norm2", t) + mlp(f"{b}.mlp", t, h, "normal")
    out += ln("norm", t)
    return [(CHECKPOINT_PREFIX + n, s, k, sc) for n, s, k, sc in out]


def features(sd, inputs, c):
    return reference.patches(sd, inputs["organized_pc"], inputs["points_compact"], c)


def load(backbone, fusion, sd) -> None:
    from cmdiad_tpu_torch.models import convert
    convert.load_named(backbone.point, convert.strip_pointmae_prefixes(sd))


def widths(backbone, fusion) -> dict:
    return dataclasses.asdict(backbone.pm_config)
