"""Method, backbone and fusion-net factory of the port."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.device import resolve_device
from cmdiad_tpu_torch.methods import variants
from cmdiad_tpu_torch.models import bridge, convert
from cmdiad_tpu_torch.models.backbone import DualBackbone, init_weights
from cmdiad_tpu_torch.models.hallucination import FtoFConv, FtoFMlp, FtoIConv, FtoIMlp
from cmdiad_tpu_torch.models.hrnet import HRNet
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import VIT_CONFIGS
from cmdiad_tpu_torch.train.checkpoint import load_pytree

_METHODS = {
    "DINO": variants.RGBMethod,
    "Point_MAE": variants.PointMethod,
    "DINO+Point_MAE": variants.DoubleMethod,
    "Depth": variants.DepthMethod,
    "WithHallucination": variants.HallucinationMethod,
    "WithHallucinationFromFeature": variants.HallucinationFromFeatureMethod,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_fusion(cfg: Config, backbone: DualBackbone, device="cuda"):
    """The configured MTFI fusion net on ``device``, or None.

    Feature widths come from the backbone (the reference hard-codes 768),
    the FtoI nets give ``cfg.xyz_size`` images, the net computes in
    ``cfg.compute_dtype``.  Weights come from ``cfg.fusion_module_path``: a
    reference ``.pth``/``.pt`` state dict, or the JAX package's npz
    variables; without a path, from a seeded generator (``cfg.seed + 2``).
    """
    dtype = _DTYPES[cfg.compute_dtype]
    xyz_dim = backbone.pm_config.out_dim
    rgb_dim = backbone.vit_config.embed_dim
    main_dim = rgb_dim if cfg.main_modality == "rgb" else xyz_dim
    if cfg.use_hn:
        net, to_sd = FtoFMlp(xyz_dim, rgb_dim, dtype=dtype), bridge.ftof_mlp_state_dict
    elif cfg.use_hn_conv:
        net, to_sd = FtoFConv(xyz_dim, rgb_dim, dtype=dtype), bridge.ftof_conv_state_dict
    elif cfg.use_hn_from_rgb_mlp:
        net = FtoIMlp(main_dim, out_size=cfg.xyz_size, dtype=dtype)
        to_sd = bridge.ftoi_mlp_state_dict
    elif cfg.use_hn_from_rgb_conv:
        net = FtoIConv(main_dim, out_size=cfg.xyz_size, dtype=dtype)
        to_sd = bridge.ftoi_conv_state_dict
    elif cfg.use_hrnet:
        net = HRNet(xyz_dim if cfg.main_modality == "rgb" else rgb_dim, dtype=dtype)
        to_sd = bridge.hrnet_state_dict
    else:
        return None
    path = cfg.fusion_module_path
    if path.endswith((".pth", ".pt")):
        convert.load_reference_state(net, convert.load_torch_checkpoint(path))
    elif path:
        net.load_state_dict(to_sd(load_pytree(path)))
    else:
        init_weights(net, cfg.seed + 2, fan_in_scaled=True)
    return net.to(resolve_device(device)).eval()


def load_backbone_params(cfg: Config, backbone: DualBackbone) -> None:
    """Load ``cfg.rgb_ckpt_path`` (timm names) into the ViT and
    ``cfg.xyz_ckpt_path`` (Point-MAE or Point-BERT, prefixes stripped as the
    reference does) into the point transformer, in place."""
    if cfg.rgb_ckpt_path:
        convert.load_named(backbone.vit, convert.load_torch_checkpoint(cfg.rgb_ckpt_path))
    if cfg.xyz_ckpt_path:
        sd = convert.load_torch_checkpoint(cfg.xyz_ckpt_path)
        strip = (convert.strip_pointbert_prefixes if cfg.xyz_backbone_name == "Point_Bert"
                 else convert.strip_pointmae_prefixes)
        convert.load_named(backbone.point, strip(sd))
    backbone.to(backbone.device)


def build_backbone(cfg: Config, device="cuda") -> DualBackbone:
    """The DualBackbone of a config: random weights from ``cfg.seed``, then
    the configured checkpoints; the ViT takes ``cfg.rgb_size`` images.
    ``xyz_backbone_name='tiny'`` is the JAX package's small Point-MAE (16
    wide, 2 blocks, 2 heads); ``'Point_Bert'`` the encoder_dims=256 one."""
    pm = dict(num_group=cfg.num_group, group_size=cfg.group_size)
    if cfg.xyz_backbone_name == "tiny":
        pm_config = PointMAEConfig(**pm, encoder_dims=16, trans_dim=16, depth=2,
                                   num_heads=2, fetch_idx=(0, 1))
    elif cfg.xyz_backbone_name == "Point_Bert":
        pm_config = PointMAEConfig(**pm, encoder_dims=256)
    else:
        pm_config = PointMAEConfig(**pm)
    vit_config = dataclasses.replace(VIT_CONFIGS[cfg.rgb_backbone_name],
                                     img_size=cfg.rgb_size)
    backbone = DualBackbone(
        vit_config=vit_config, pm_config=pm_config,
        compute_dtype=cfg.compute_dtype, use_flash=cfg.use_flash,
        device=device, seed=cfg.seed)
    load_backbone_params(cfg, backbone)
    return backbone


def build_method(cfg: Config, backbone: Optional[DualBackbone] = None,
                 device="cuda", fusion=None):
    """The configured method on ``backbone`` (built from the config on
    ``device`` when None) with the fusion net ``fusion`` (built from the
    config when None)."""
    cfg = cfg.validate()
    if backbone is None:
        backbone = build_backbone(cfg, device)
    if fusion is None:
        fusion = build_fusion(cfg, backbone, backbone.device)
    return _METHODS[cfg.method_name](cfg, backbone, fusion=fusion)
