"""DualBackbone: the frozen rgb + xyz feature extractor.

  rgb_patches   ViT grid -> rgb_patch  (B, 784, 768)   28x28, row-major
                         -> rgb_patch2 (B, 3136, 768)  adaptive-avg-pooled to 56²
  xyz_patches   masked FPS + KNN grouping over the (compacted) valid points
                -> Point-MAE group features (B, G, 768)
                -> 3-NN IDW interpolation onto the full H*W grid
                -> 3x3-valid + adaptive average pool to 56² -> (B, 3136, 768)
                [-> and to 28², xyz_patch_2828 (B, 784, 768), for the
                   rgb + fxyz feature dumps]
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cmdiad_tpu_torch.device import resolve_device
from cmdiad_tpu_torch.models.point_mae import (PointMAEConfig, PointTransformer,
                                               group_points)
from cmdiad_tpu_torch.models.vit import VIT_CONFIGS, ViTConfig, VisionTransformer
from cmdiad_tpu_torch.ops.interpolate import three_nn_interpolate
from cmdiad_tpu_torch.ops.masked import compact_points, nonzero_point_mask
from cmdiad_tpu_torch.ops.pooling import adaptive_avg_pool, avg3x3_then_adaptive_pool


def init_weights(module: nn.Module, seed: int, fan_in_scaled: bool = False) -> None:
    """Random weights from a seeded ``torch.Generator``: normal(0, 0.02)
    for matrices, convolutions and embeddings (with ``fan_in_scaled``,
    normal(0, 1/sqrt(fan in)) for matrices and convolutions), zeros for
    biases, ones for norm scales, 1e-5 for LayerScale, identity BatchNorm
    statistics."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            if isinstance(owner, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "gamma":
                p.fill_(1e-5)
            else:
                std = p[0].numel() ** -0.5 if fan_in_scaled and p.dim() > 1 else 0.02
                p.copy_(torch.randn(p.shape, generator=gen) * std)
        for name, buf in module.named_buffers():
            if name.endswith("running_mean") or name.endswith("num_batches_tracked"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)


class DualBackbone:
    """Frozen rgb + xyz feature extractor (reference ``models.Model``)."""

    def __init__(self, rgb_backbone_name: str = "vit_base_patch8_224_dino",
                 num_group: int = 1024, group_size: int = 128,
                 compute_dtype: str = "float32",
                 vit_config: Optional[ViTConfig] = None,
                 pm_config: Optional[PointMAEConfig] = None,
                 point_capacity: Optional[int] = 32768,
                 use_flash: bool = False, device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
        self.vit_config = vit_config or VIT_CONFIGS[rgb_backbone_name]
        self.pm_config = pm_config or PointMAEConfig(num_group=num_group,
                                                     group_size=group_size)
        # valid points are compacted to a dense prefix of this many slots
        # before FPS/KNN when the grid has more cells; None disables
        self.point_capacity = point_capacity
        # built on the meta device so construction draws no random numbers;
        # every weight then comes from the seeded generator.  use_flash sends
        # the attention of both networks through the fused kernel
        # (ops/flash_attn.py) instead of the einsum form
        with torch.device("meta"):
            self.vit = VisionTransformer(self.vit_config, dtype=dtype,
                                         use_flash=use_flash)
            self.point = PointTransformer(self.pm_config, dtype=dtype,
                                          use_flash=use_flash)
        self.vit.to_empty(device="cpu")
        self.point.to_empty(device="cpu")
        init_weights(self.vit, seed)
        init_weights(self.point, seed + 1)
        self.to(self.device)

    def to(self, device) -> "DualBackbone":
        """Move both networks to ``device`` (in place); returns self."""
        self.device = resolve_device(device)
        self.vit.to(self.device).eval()
        self.point.to(self.device).eval()
        return self

    @torch.no_grad()
    def rgb_patches(self, images: torch.Tensor):
        """images (B, H, W, 3) -> (rgb_patch (B, g², C), rgb_patch2 (B, 3136, C))."""
        grid = self.vit(images.to(self.device))
        b, g, _, c = grid.shape
        rgb_patch = grid.reshape(b, g * g, c)
        rgb_patch2 = adaptive_avg_pool(grid, 56).reshape(b, 56 * 56, c)
        return rgb_patch.to(torch.float32), rgb_patch2.to(torch.float32)

    @torch.no_grad()
    def xyz_patches(self, organized_pc: torch.Tensor, compact_pts=None,
                    with_2828: bool = False) -> dict:
        """organized_pc (B, H, W, 3) -> dict with xyz_patch (B, 3136, 768),
        centers, ori_idx, center_idx and group_feats, and with ``with_2828``
        xyz_patch_2828 (B, 784, 768), the same grid pooled to 28².

        ``compact_pts`` (B, capacity, 3): valid points already compacted on
        the host (``ops.masked.host_compact_points``); otherwise the grid
        is compacted on the device when ``point_capacity`` < H*W.
        """
        organized_pc = organized_pc.to(self.device, torch.float32)
        b, h, w, _ = organized_pc.shape
        points = organized_pc.reshape(b, h * w, 3)
        mask = nonzero_point_mask(points)
        if compact_pts is not None:
            work_pts = compact_pts.to(self.device, torch.float32)
        elif self.point_capacity and self.point_capacity < h * w:
            work_pts = compact_points(points, mask, self.point_capacity)
        else:
            work_pts = points
        work_mask = nonzero_point_mask(work_pts)
        centers, ori_idx, center_idx = group_points(
            work_pts, work_mask, self.pm_config.num_group,
            self.pm_config.group_size)
        feats = self.point(work_pts, centers, ori_idx).to(torch.float32)
        interp = three_nn_interpolate(points, mask, centers, feats,
                                      compute_dtype=self.compute_dtype)
        grid = interp.reshape(b, h, w, -1)
        xyz_patch = avg3x3_then_adaptive_pool(grid, 56).reshape(b, 56 * 56, -1)
        out = {"xyz_patch": xyz_patch.to(torch.float32), "centers": centers,
               "ori_idx": ori_idx, "center_idx": center_idx,
               "group_feats": feats}
        if with_2828:
            out["xyz_patch_2828"] = avg3x3_then_adaptive_pool(grid, 28).reshape(
                b, 28 * 28, -1).to(torch.float32)
        return out

    def extract(self, images=None, organized_pc=None, compact_pts=None,
                with_2828: bool = False) -> dict:
        """Features of whichever modalities are given (reference
        ``Features.__call__``)."""
        out = {}
        if images is not None:
            out["rgb_patch"], out["rgb_patch2"] = self.rgb_patches(images)
        if organized_pc is not None:
            out.update(self.xyz_patches(organized_pc, compact_pts, with_2828))
        return out
