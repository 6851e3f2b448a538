"""Method and backbone factory of the port."""

from __future__ import annotations

import dataclasses
from typing import Optional

from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.methods import variants
from cmdiad_tpu_torch.models.backbone import DualBackbone
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import VIT_CONFIGS

_PORTED = {
    "DINO": variants.RGBMethod,
    "Point_MAE": variants.PointMethod,
    "DINO+Point_MAE": variants.DoubleMethod,
    "Depth": variants.DepthMethod,
}


def build_backbone(cfg: Config, device="cuda") -> DualBackbone:
    """The DualBackbone of a config, with random weights from ``cfg.seed``;
    the ViT takes ``cfg.rgb_size`` images.  ``xyz_backbone_name='tiny'`` is
    the JAX package's small Point-MAE (16 wide, 2 blocks, 2 heads).
    Checkpoint loading is not ported yet."""
    if cfg.rgb_ckpt_path or cfg.xyz_ckpt_path:
        raise NotImplementedError("checkpoint loading is not ported yet")
    if cfg.xyz_backbone_name == "tiny":
        pm_config = PointMAEConfig(
            num_group=cfg.num_group, group_size=cfg.group_size,
            encoder_dims=16, trans_dim=16, depth=2, num_heads=2, fetch_idx=(0, 1))
    elif cfg.xyz_backbone_name == "Point_MAE":
        pm_config = PointMAEConfig(num_group=cfg.num_group, group_size=cfg.group_size)
    else:
        raise NotImplementedError(
            f"xyz backbone {cfg.xyz_backbone_name!r} is not ported yet")
    vit_config = dataclasses.replace(VIT_CONFIGS[cfg.rgb_backbone_name],
                                     img_size=cfg.rgb_size)
    return DualBackbone(
        vit_config=vit_config, pm_config=pm_config,
        compute_dtype=cfg.compute_dtype, use_flash=cfg.use_flash,
        device=device, seed=cfg.seed)


def build_method(cfg: Config, backbone: Optional[DualBackbone] = None,
                 device="cuda"):
    """The configured method on ``backbone`` (built from the config on
    ``device`` when None)."""
    cfg = cfg.validate()
    if cfg.method_name not in _PORTED:
        raise NotImplementedError(f"method {cfg.method_name!r}: not yet ported")
    if backbone is None:
        backbone = build_backbone(cfg, device)
    return _PORTED[cfg.method_name](cfg, backbone)
