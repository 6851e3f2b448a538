"""Plain ViT forward (timm's ``vit_base_patch8_224_dino`` as M3DM runs it):
conv patch embedding, cls token and learned positions, pre-LN blocks with
exact-GELU MLPs, the final LayerNorm, the patch tokens as a grid."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ln(sd, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _lin(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


def attention(sd, name, x, heads):
    """Multi-head self-attention with an explicit float32 softmax."""
    b, n, c = x.shape
    qkv = _lin(sd, f"{name}.qkv", x).reshape(b, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    a = torch.softmax((q @ k.transpose(-1, -2)) * (c // heads) ** -0.5, dim=-1)
    return _lin(sd, f"{name}.proj", (a @ v).transpose(1, 2).reshape(b, n, c))


def block(sd, name, x, heads, eps):
    x = x + attention(sd, f"{name}.attn", _ln(sd, f"{name}.norm1", x, eps), heads)
    h = F.gelu(_lin(sd, f"{name}.mlp.fc1", _ln(sd, f"{name}.norm2", x, eps)))
    return x + _lin(sd, f"{name}.mlp.fc2", h)


@torch.no_grad()
def patches(sd, images, c):
    """images (B, H, W, 3) ImageNet-normalised -> patch tokens (B, g*g, C)."""
    x = F.conv2d(images.permute(0, 3, 1, 2), sd["patch_embed.proj.weight"],
                 sd["patch_embed.proj.bias"], stride=c["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["cls_token"].expand(x.shape[0], -1, -1), x], 1) + sd["pos_embed"]
    for i in range(c["depth"]):
        x = block(sd, f"blocks.{i}", x, c["num_heads"], c["ln_eps"])
    return _ln(sd, "norm", x, c["ln_eps"])[:, 1:]
