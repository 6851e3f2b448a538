"""Method and backbone factory of the port."""

from __future__ import annotations

from typing import Optional

from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.methods import variants
from cmdiad_tpu_torch.models.backbone import DualBackbone

_PORTED = {"DINO+Point_MAE": variants.DoubleMethod}


def build_backbone(cfg: Config, device="cuda") -> DualBackbone:
    """The DualBackbone of a config, with random weights from ``cfg.seed``.
    Checkpoint loading is not ported yet."""
    if cfg.rgb_ckpt_path or cfg.xyz_ckpt_path:
        raise NotImplementedError("checkpoint loading is not ported yet")
    if cfg.xyz_backbone_name != "Point_MAE":
        raise NotImplementedError(
            f"xyz backbone {cfg.xyz_backbone_name!r} is not ported yet")
    return DualBackbone(
        rgb_backbone_name=cfg.rgb_backbone_name, num_group=cfg.num_group,
        group_size=cfg.group_size, compute_dtype=cfg.compute_dtype,
        use_flash=cfg.use_flash, device=device, seed=cfg.seed)


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
