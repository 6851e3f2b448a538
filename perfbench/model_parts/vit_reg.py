"""timm's ViT with LayerScale and register tokens, as DINOv2 ViT-L/14-reg4
releases it: the rgb backbone (``perfbench/reference/vit_reg.py``), loaded
into the port's ``DualBackbone.vit``.  Its block states ``layer_scale``
true and ``num_reg_tokens`` of at least one (``pos_embed`` covers the
patches alone); the shape check holds the program to both."""

from __future__ import annotations

import dataclasses
from typing import List

from perfbench.core.weights import Leaf, ln, mlp
from perfbench.reference import vit_reg as reference

ROLE = "rgb"
CHECKPOINT_PREFIX = ""
NOT_WIDTHS = ("source",)


def leaves(c: dict) -> List[Leaf]:
    d, p, n = c["embed_dim"], c["patch_size"], (c["img_size"] // c["patch_size"]) ** 2
    h = int(d * c["mlp_ratio"])
    out: List[Leaf] = [
        ("patch_embed.proj.weight", (d, 3, p, p), "normal", 0.02),
        ("patch_embed.proj.bias", (d,), "normal", 0.02),
        ("cls_token", (1, 1, d), "normal", 0.02),
        ("reg_token", (1, c["num_reg_tokens"], d), "normal", 0.02),
        ("pos_embed", (1, n, d), "normal", 0.02)]
    for i in range(c["depth"]):
        t = f"blocks.{i}"
        out += ln(f"{t}.norm1", d) + [
            (f"{t}.attn.qkv.weight", (3 * d, d), "normal", 0.02)]
        if c["qkv_bias"]:
            out.append((f"{t}.attn.qkv.bias", (3 * d,), "normal", 0.02))
        out += [(f"{t}.attn.proj.weight", (d, d), "normal", 0.02),
                (f"{t}.attn.proj.bias", (d,), "normal", 0.02)]
        out.append((f"{t}.ls1.gamma", (d,), "one", 0.02))
        out += ln(f"{t}.norm2", d) + mlp(f"{t}.mlp", d, h, "normal")
        out.append((f"{t}.ls2.gamma", (d,), "one", 0.02))
    return out + ln("norm", d)


def features(sd, inputs, c):
    return reference.patches(sd, inputs["rgb"], c)


def load(backbone, fusion, sd) -> None:
    from cmdiad_tpu_torch.models import convert
    convert.load_named(backbone.vit, sd)


def widths(backbone, fusion) -> dict:
    return dataclasses.asdict(backbone.vit_config)
