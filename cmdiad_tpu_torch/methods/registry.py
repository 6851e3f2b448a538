"""Method, backbone and fusion-net factory of the port."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.device import resolve_device
from cmdiad_tpu_torch.methods import variants
from cmdiad_tpu_torch.models import convert, names
from cmdiad_tpu_torch.models.backbone import DualBackbone, init_weights
from cmdiad_tpu_torch.models.hallucination import FtoFConv, FtoFMlp, FtoIConv, FtoIMlp
from cmdiad_tpu_torch.models.hrnet import HRNet
from cmdiad_tpu_torch.models.point_mae import POINT_CONFIGS
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
    # each net with its name table, a function of the file's variables: the
    # FtoF MLP's depth is counted from them
    if cfg.use_hn:
        net = FtoFMlp(xyz_dim, rgb_dim, dtype=dtype)
        table = lambda v: names.ftof_mlp(len(v["params"]["xyz_mlp"]))
    elif cfg.use_hn_conv:
        net, table = FtoFConv(xyz_dim, rgb_dim, dtype=dtype), lambda v: names.ftof_conv()
    elif cfg.use_hn_from_rgb_mlp:
        net = FtoIMlp(main_dim, out_size=cfg.xyz_size, dtype=dtype)
        table = lambda v: names.ftoi_mlp()
    elif cfg.use_hn_from_rgb_conv:
        net = FtoIConv(main_dim, out_size=cfg.xyz_size, dtype=dtype)
        table = lambda v: names.ftoi_conv()
    elif cfg.use_hrnet:
        net = HRNet(xyz_dim if cfg.main_modality == "rgb" else rgb_dim, dtype=dtype)
        table = lambda v: names.hrnet()
    else:
        return None
    path = cfg.fusion_module_path
    if path.endswith((".pth", ".pt")):
        convert.load_reference_state(net, convert.load_torch_checkpoint(path))
    elif path:
        variables = load_pytree(path)
        net.load_state_dict(names.to_torch(table(variables), variables))
    else:
        init_weights(net, cfg.seed + 2, fan_in_scaled=True)
    return net.to(resolve_device(device)).eval()


def load_backbone_params(cfg: Config, backbone: DualBackbone) -> None:
    """Load ``cfg.rgb_ckpt_path`` (timm names) into the ViT and
    ``cfg.xyz_ckpt_path`` (Point-MAE or Point-BERT, prefixes stripped as the
    reference does) into the point transformer, in place; the transformer's
    flavour picks the remap."""
    if cfg.rgb_ckpt_path:
        convert.load_named(backbone.vit, convert.load_torch_checkpoint(cfg.rgb_ckpt_path))
    if cfg.xyz_ckpt_path:
        sd = convert.load_torch_checkpoint(cfg.xyz_ckpt_path)
        strip = (convert.strip_pointbert_prefixes if backbone.point.with_cls
                 else convert.strip_pointmae_prefixes)
        convert.load_named(backbone.point, strip(sd))
    backbone.to(backbone.device)


def build_backbone(cfg: Config, device="cuda") -> DualBackbone:
    """The DualBackbone of a config: the named entries of ``VIT_CONFIGS``
    and ``POINT_CONFIGS`` (an unknown point name is Point-MAE), random
    weights from ``cfg.seed``, then the configured checkpoints; the ViT
    takes ``cfg.rgb_size`` images, the point transformer ``cfg.num_group``
    groups of ``cfg.group_size``."""
    pm_config = dataclasses.replace(
        POINT_CONFIGS.get(cfg.xyz_backbone_name, POINT_CONFIGS["Point_MAE"]),
        num_group=cfg.num_group, group_size=cfg.group_size)
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
