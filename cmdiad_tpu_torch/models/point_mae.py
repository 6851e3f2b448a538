"""Point-MAE and Point-BERT point-cloud backbones in PyTorch with masked
grouping.

The reference ``PointTransformer`` (Point_MAE flavour: encoder_dims ==
trans_dim == 384, no cls token; the Point-BERT flavour below):

  Group        masked FPS -> G=1024 centers, exact KNN -> M=128 neighbours.
  Encoder      per-group mini-PointNet: Conv1d(3->128)+BN+ReLU+Conv1d(128->256),
               max-pool skip concat to 512, Conv1d(512->512)+BN+ReLU+
               Conv1d(512->384), max-pool.
  Transformer  12 pre-LN blocks, dim 384, 6 heads, no qkv bias; the center
               position embedding is added at every block input.  Features
               after blocks {3, 11}, each through the shared final
               LayerNorm, concatenated to 768 channels.

Point-BERT (``encoder_dims`` 256 != ``trans_dim``): the encoder's tokens go
through ``reduce_dim`` to 384 wide, a learned ``cls_token``/``cls_pos`` is
prepended to the tokens and to the position embedding, and cls is dropped
from each fetched layer after the final LayerNorm.

Module names follow the Point-MAE checkpoint (``encoder.first_conv.0``,
``blocks.blocks.{i}.attn.qkv``, ...), so a prefix-stripped checkpoint loads
directly.  BatchNorms run in eval mode (frozen statistics, eps 1e-5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cmdiad_tpu_torch.models.vit import Block, layer_norm, linear
from cmdiad_tpu_torch.ops.fps import farthest_point_sample
from cmdiad_tpu_torch.ops.knn import masked_knn


@dataclass(frozen=True)
class PointMAEConfig:
    num_group: int = 1024
    group_size: int = 128
    encoder_dims: int = 384
    trans_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = False
    ln_eps: float = 1e-5
    fetch_idx: Tuple[int, ...] = (3, 11)

    @property
    def out_dim(self) -> int:
        return self.trans_dim * len(self.fetch_idx)


def group_points(points, mask, num_group: int, group_size: int):
    """Masked FPS + KNN grouping indices: points (B, P, 3), mask (B, P) ->
    centers (B, G, 3), ori_idx (B, G, M), center_idx (B, G)."""
    centers, center_idx = farthest_point_sample(points, mask, num_group)
    ori_idx = masked_knn(points, mask, centers, group_size)
    return centers, ori_idx, center_idx


def _conv1x1(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-1 Conv1d applied as a linear map on the last axis."""
    return F.linear(x, conv.weight[:, :, 0].to(x.dtype), conv.bias.to(x.dtype))


def _bn(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm on (N, C)."""
    return F.batch_norm(x, bn.running_mean.to(x.dtype), bn.running_var.to(x.dtype),
                        bn.weight.to(x.dtype), bn.bias.to(x.dtype), False, 0.0,
                        bn.eps)


class GroupEncoder(nn.Module):
    """Per-group mini-PointNet -> (B, G, encoder_dims).

    The first 1x1 conv runs BEFORE the neighbourhood gather, as
    (gather(W p + b) - (W c + b)) + b — the same linear map as W (p - c) + b
    with the JAX package's rounding order.
    """

    def __init__(self, encoder_dims: int = 384):
        super().__init__()
        self.encoder_dims = encoder_dims
        self.first_conv = nn.Sequential(
            nn.Conv1d(3, 128, 1), nn.BatchNorm1d(128, eps=1e-5), nn.ReLU(),
            nn.Conv1d(128, 256, 1))
        self.second_conv = nn.Sequential(
            nn.Conv1d(512, 512, 1), nn.BatchNorm1d(512, eps=1e-5), nn.ReLU(),
            nn.Conv1d(512, encoder_dims, 1))

    def forward(self, points, centers, idx):
        """points (B, P, 3), centers (B, G, 3), idx (B, G, M) -> (B, G, C)."""
        d0 = self.first_conv[0]
        p_emb = _conv1x1(d0, points)                        # (B, P, 128)
        c_emb = _conv1x1(d0, centers)                       # (B, G, 128)
        bias = d0.bias.to(points.dtype)
        b, g, m = idx.shape
        gathered = torch.gather(
            p_emb, 1, idx.reshape(b, g * m, 1).expand(-1, -1, p_emb.shape[-1]))
        feat0 = (gathered.reshape(b, g, m, -1) - c_emb[:, :, None, :]) + bias
        x = feat0.reshape(b * g * m, -1)
        x = F.relu(_bn(self.first_conv[1], x))
        x = _conv1x1(self.first_conv[3], x).reshape(b * g, m, 256)
        gmax = torch.amax(x, dim=1, keepdim=True)
        x = torch.cat([gmax.expand_as(x), x], dim=-1).reshape(b * g * m, 512)
        x = F.relu(_bn(self.second_conv[1], _conv1x1(self.second_conv[0], x)))
        x = _conv1x1(self.second_conv[3], x)
        x = torch.amax(x.reshape(b * g, m, self.encoder_dims), dim=1)
        return x.reshape(b, g, self.encoder_dims)


# A Point-MAE transformer block is the ViT's pre-LN block: same structure
# and parameter names, LayerNorm eps 1e-5 and no qkv bias here.
PointBlock = Block


class _Blocks(nn.Module):
    def __init__(self, cfg: PointMAEConfig, use_flash: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            PointBlock(cfg.trans_dim, cfg.num_heads, cfg.mlp_ratio,
                       cfg.qkv_bias, cfg.ln_eps, use_flash)
            for _ in range(cfg.depth))


class PointTransformer(nn.Module):
    """Encoder + transformer over grouped point tokens -> (B, G, out_dim)."""

    def __init__(self, config: PointMAEConfig = PointMAEConfig(),
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.encoder = GroupEncoder(c.encoder_dims)
        # Point-BERT: project the tokens and prepend a learned cls token
        self.with_cls = c.encoder_dims != c.trans_dim
        if self.with_cls:
            self.reduce_dim = nn.Linear(c.encoder_dims, c.trans_dim)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, c.trans_dim))
            self.cls_pos = nn.Parameter(torch.zeros(1, 1, c.trans_dim))
        self.pos_embed = nn.Sequential(
            nn.Linear(3, 128), nn.GELU(), nn.Linear(128, c.trans_dim))
        self.blocks = _Blocks(c, use_flash)
        self.norm = nn.LayerNorm(c.trans_dim, eps=c.ln_eps)

    def forward(self, points, centers, idx):
        c, dt = self.config, self.dtype
        x = self.encoder(points.to(dt), centers.to(dt), idx)
        pos = linear(self.pos_embed[2],
                     F.gelu(linear(self.pos_embed[0], centers.to(dt))))
        if self.with_cls:
            b = x.shape[0]
            x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1),
                           linear(self.reduce_dim, x)], dim=1)
            pos = torch.cat([self.cls_pos.to(dt).expand(b, -1, -1), pos], dim=1)
        first = 1 if self.with_cls else 0
        fetched = []
        for i, blk in enumerate(self.blocks.blocks):
            x = blk(x + pos)
            if i in c.fetch_idx:
                fetched.append(layer_norm(self.norm, x)[:, first:])
        return torch.cat(fetched, dim=-1)
