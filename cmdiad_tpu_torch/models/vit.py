"""Vision Transformer (ViT-B/8 DINO, ViT-B/14, ViT-L/14-reg4 and ViT-g/14-reg4
DINOv2) in PyTorch.

The RGB backbone of the reference (timm ``vit_base_patch8_224_dino`` run
as patch_embed -> pos_embed -> 12 blocks -> norm, the patch tokens
reshaped to a 28x28x768 grid): pre-LN blocks, conv patch embedding, cls
token + learned position embeddings, 4x exact-GELU MLPs, LayerNorm eps
1e-6, qkv with bias.  DINOv2 adds LayerScale (``ls{1,2}.gamma``) and, in its
register flavour, register tokens under timm's ``no_embed_class`` rule:
``pos_embed`` covers the patches only and is added before cls and the
registers are prepended.  DINOv2's ViT-g replaces the GELU MLP with timm's
``SwiGLUPacked`` (DINOv2's ``SwiGLUFFNFused``): ``fc1`` maps to twice the
hidden width, ``silu`` of the first half times the second goes into ``fc2``
(``ViTConfig.ffn``).  Module names follow timm, so a timm state dict loads
directly.

Attention goes through ``ops.flash_attn.fused_attention``, whose route
follows the operands: on a card the fused kernel runs with ``use_flash``
(the JAX package's switch of the same name) and for every float32 call at
head dim 64 that needs no gradient, whatever ``use_flash`` says; the rest
takes the einsum form.  Point-MAE's blocks are these blocks, so that one
call site serves both backbones.

Under the profiler (``tracing.py``) each of the ViT's blocks opens the spans
``vit_attention`` (norm1, qkv, attention, proj, ``ls1``, residual) and
``vit_mlp`` (norm2, MLP, ``ls2``, residual), the gated FFN ``vit_gate``
inside ``vit_mlp`` (``silu(x1) * x2``), and its attention counts
``vit_attn_score_bytes``, the bytes of the (B, H, N, N) scores the einsum
form writes (0 where the call took the kernel or the plain fused form).
Point-MAE's blocks open neither span and count nothing: they run inside its
``point_blocks`` span.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from cmdiad_tpu_torch import tracing
from cmdiad_tpu_torch.ops.flash_attn import fused_attention


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 8
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    # DINOv2: LayerScale on both residual branches, and register tokens
    layer_scale: bool = False
    num_reg_tokens: int = 0
    # the FFN, a key of FFNS: "gelu" or "swiglu" (the gated SiLU MLP)
    ffn: str = "gelu"
    # the FFN's hidden width, what fc2 reads; 0 takes int(embed_dim * mlp_ratio)
    mlp_hidden: int = 0

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


VIT_CONFIGS = {
    "vit_base_patch8_224_dino": ViTConfig(),
    "vit_base_patch8_224": ViTConfig(),
    "vit_base_patch8_224_in21k": ViTConfig(),
    "vit_small_patch8_224_dino": ViTConfig(embed_dim=384, num_heads=6),
    # DINOv2 ViT-B/14 at 518²: a 37x37 patch grid
    "vit_base_patch14_dinov2.lvd142m": ViTConfig(img_size=518, patch_size=14,
                                                  layer_scale=True),
    # DINOv2 ViT-L/14 with four registers: 1 + 4 + 1369 tokens, 37x37x1024
    "vit_large_patch14_reg4_dinov2.lvd142m": ViTConfig(
        img_size=518, patch_size=14, embed_dim=1024, depth=24, num_heads=16,
        layer_scale=True, num_reg_tokens=4),
    # DINOv2 ViT-g/14 with four registers: 40 blocks of 1536, 24 heads, the
    # gated FFN (fc1 8192, fc2 4096).  DINOv2 states mlp_ratio 4 and takes
    # 2/3 of the 6144 rounded up to 8; the width is given as it comes out
    "vit_giant_patch14_reg4_dinov2.lvd142m": ViTConfig(
        img_size=518, patch_size=14, embed_dim=1536, depth=40, num_heads=24,
        layer_scale=True, num_reg_tokens=4, ffn="swiglu", mlp_hidden=4096),
    "tiny": ViTConfig(img_size=64, embed_dim=32, depth=2, num_heads=2),
}


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in float32, returned in the input's dtype."""
    return F.layer_norm(x.to(torch.float32), norm.normalized_shape,
                        norm.weight.to(torch.float32), norm.bias.to(torch.float32),
                        norm.eps).to(x.dtype)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Linear layer in the input's dtype (parameters are cast to it)."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


class Attention(nn.Module):
    # the tracing counter of the einsum form's score bytes (None: uncounted)
    score_counter = None

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = linear(self.qkv, x).reshape(b, n, 3, self.num_heads, hd)
        out = fused_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              hd ** -0.5, use_flash=self.use_flash,
                              score_counter=self.score_counter)
        return linear(self.proj, out.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(self.fc2, F.gelu(linear(self.fc1, x)))


class GluMlp(nn.Module):
    """timm's ``SwiGLUPacked``: ``fc1`` to twice the hidden width, SiLU on
    the first half times the second half, ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 2 * hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = linear(self.fc1, x).chunk(2, -1)
        with tracing.span("vit_gate"):
            h = F.silu(x1) * x2
        return linear(self.fc2, h)


FFNS = {"gelu": Mlp, "swiglu": GluMlp}


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, ln_eps,
                 use_flash: bool = False, layer_scale: bool = False,
                 ffn: str = "gelu", mlp_hidden: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = FFNS[ffn](dim, mlp_hidden or int(dim * mlp_ratio))
        self.ls1 = LayerScale(dim) if layer_scale else nn.Identity()
        self.ls2 = LayerScale(dim) if layer_scale else nn.Identity()

    def attention_residual(self, x):
        return x + self.ls1(self.attn(layer_norm(self.norm1, x)))

    def mlp_residual(self, x):
        return x + self.ls2(self.mlp(layer_norm(self.norm2, x)))

    def forward(self, x):
        return self.mlp_residual(self.attention_residual(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class VisionTransformer(nn.Module):
    """Forward-features ViT returning the patch-token grid (B, g, g, C)."""

    def __init__(self, config: ViTConfig = ViTConfig(),
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.use_flash = use_flash
        self.patch_embed = PatchEmbed(c.patch_size, c.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        if c.num_reg_tokens:
            self.reg_token = nn.Parameter(torch.zeros(1, c.num_reg_tokens, c.embed_dim))
        n_pos = c.num_patches + (0 if c.num_reg_tokens else 1)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, c.embed_dim))
        self.blocks = nn.ModuleList(
            Block(c.embed_dim, c.num_heads, c.mlp_ratio, c.qkv_bias, c.ln_eps,
                  use_flash, c.layer_scale, c.ffn, c.mlp_hidden) for _ in range(c.depth))
        for blk in self.blocks:
            blk.attn.score_counter = "vit_attn_score_bytes"
        self.norm = nn.LayerNorm(c.embed_dim, eps=c.ln_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3), resized and ImageNet-normalised."""
        c, dt = self.config, self.dtype
        b = images.shape[0]
        conv = self.patch_embed.proj
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt),
                     conv.bias.to(dt), stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)                       # (B, N, C)
        cls = self.cls_token.to(dt).expand(b, -1, -1)
        if c.num_reg_tokens:
            x = x + self.pos_embed.to(dt)
            x = torch.cat([cls, self.reg_token.to(dt).expand(b, -1, -1), x], dim=1)
        else:
            x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for blk in self.blocks:
            with tracing.span("vit_attention"):
                x = blk.attention_residual(x)
            with tracing.span("vit_mlp"):
                x = blk.mlp_residual(x)
        x = layer_norm(self.norm, x)
        n_prefix = 1 + c.num_reg_tokens
        return x[:, n_prefix:].reshape(b, c.grid, c.grid, c.embed_dim)
