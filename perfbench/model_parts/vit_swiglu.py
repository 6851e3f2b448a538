"""timm's ViT with LayerScale, register tokens and the packed SwiGLU FFN, as
DINOv2 ViT-g/14-reg4 releases it: the rgb backbone
(``perfbench/reference/vit_swiglu.py``), loaded into the port's
``DualBackbone.vit``.  Its block states ``ffn`` ``"swiglu"`` and the FFN's
hidden width ``mlp_hidden`` (``mlp.fc1`` is twice as wide), with
``layer_scale`` and ``num_reg_tokens`` as ``vit_reg``'s; the shape check
holds the program to each."""

from __future__ import annotations

import dataclasses
from typing import List

from perfbench.core.weights import Leaf
from perfbench.model_parts import vit_reg
from perfbench.reference import vit_swiglu as reference

ROLE = "rgb"
CHECKPOINT_PREFIX = ""
NOT_WIDTHS = ("source",)


def leaves(c: dict) -> List[Leaf]:
    """``vit_reg``'s leaves, in its order, with the gated FFN's shapes:
    ``mlp.fc1`` to twice ``mlp_hidden``, ``mlp.fc2`` from it."""
    d, h = c["embed_dim"], c["mlp_hidden"]
    gated = {"fc1.weight": (2 * h, d), "fc1.bias": (2 * h,), "fc2.weight": (d, h)}
    return [(name, gated.get(name.partition(".mlp.")[2], shape), kind, scale)
            for name, shape, kind, scale in vit_reg.leaves(c)]


def features(sd, inputs, c):
    return reference.patches(sd, inputs["rgb"], c)


def load(backbone, fusion, sd) -> None:
    from cmdiad_tpu_torch.models import convert
    convert.load_named(backbone.vit, sd)


def widths(backbone, fusion) -> dict:
    return dataclasses.asdict(backbone.vit_config)
