"""JAX-package parameters -> the port's PyTorch state dicts.

Takes the numpy pytree that ``jax.device_get(DualBackbone.init_params(seed))``
gives in the JAX package (or a converted checkpoint in that layout) and
returns state dicts for ``models.vit.VisionTransformer`` (DINO and
DINOv2), ``models.point_mae.PointTransformer`` (Point-MAE and Point-BERT)
and the MTFI fusion nets (``models.hallucination``, ``models.hrnet``):
Dense kernels (in, out) -> Linear weights (out, in), Conv kernels HWIO ->
OIHW, kernel-1 Conv1d weights (out, in, 1), LayerNorm/BatchNorm
``scale``/``bias`` -> ``weight``/``bias``, and BatchNorm ``batch_stats``
mean/var -> running statistics.  The names are timm's, Point-MAE's and the
reference fusion nets', the inverse of the JAX package's checkpoint
converters; the fusion nets' come from their tables in ``models.names``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cmdiad_tpu_torch.models import names


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _linear(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv1d(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv2d(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _batchnorm(sd, name, p, stats):
    _norm(sd, name, p)
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def vit_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` variables -> timm-named state dict."""
    p = variables["params"]
    sd = {"cls_token": _t(p["cls_token"]), "pos_embed": _t(p["pos_embed"])}
    if "reg_token" in p:
        sd["reg_token"] = _t(p["reg_token"])
    _conv2d(sd, "patch_embed.proj", p["patch_embed"])
    depth = sum(1 for k in p if k.startswith("blocks_"))
    for i in range(depth):
        b, t = p[f"blocks_{i}"], f"blocks.{i}"
        if "ls1" in b:
            sd[f"{t}.ls1.gamma"] = _t(b["ls1"])
            sd[f"{t}.ls2.gamma"] = _t(b["ls2"])
        _norm(sd, f"{t}.norm1", b["norm1"])
        _linear(sd, f"{t}.attn.qkv", b["attn"]["qkv"])
        _linear(sd, f"{t}.attn.proj", b["attn"]["proj"])
        _norm(sd, f"{t}.norm2", b["norm2"])
        _linear(sd, f"{t}.mlp.fc1", b["mlp"]["fc1"])
        _linear(sd, f"{t}.mlp.fc2", b["mlp"]["fc2"])
    _norm(sd, "norm", p["norm"])
    return sd


def point_mae_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``PointTransformer`` variables -> Point-MAE-named state dict
    (with Point-BERT's ``reduce_dim``, ``cls_token`` and ``cls_pos``)."""
    p, stats = variables["params"], variables["batch_stats"]
    e, es = p["encoder"], stats["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    if "reduce_dim" in p:
        _linear(sd, "reduce_dim", p["reduce_dim"])
        sd["cls_token"] = _t(p["cls_token"])
        sd["cls_pos"] = _t(p["cls_pos"])
    _conv1d(sd, "encoder.first_conv.0", e["first_conv_0"])
    _batchnorm(sd, "encoder.first_conv.1", e["first_conv_1"], es["first_conv_1"])
    _conv1d(sd, "encoder.first_conv.3", e["first_conv_3"])
    _conv1d(sd, "encoder.second_conv.0", e["second_conv_0"])
    _batchnorm(sd, "encoder.second_conv.1", e["second_conv_1"], es["second_conv_1"])
    _conv1d(sd, "encoder.second_conv.3", e["second_conv_3"])
    _linear(sd, "pos_embed.0", p["pos_embed_0"])
    _linear(sd, "pos_embed.2", p["pos_embed_2"])
    depth = sum(1 for k in p if k.startswith("blocks_"))
    for i in range(depth):
        b, t = p[f"blocks_{i}"], f"blocks.blocks.{i}"
        _norm(sd, f"{t}.norm1", b["norm1"])
        _linear(sd, f"{t}.attn.qkv", b["attn_qkv"])
        _linear(sd, f"{t}.attn.proj", b["attn_proj"])
        _norm(sd, f"{t}.norm2", b["norm2"])
        _linear(sd, f"{t}.mlp.fc1", b["mlp_fc1"])
        _linear(sd, f"{t}.mlp.fc2", b["mlp_fc2"])
    _norm(sd, "norm", p["norm"])
    return sd


def ftof_mlp_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``FtoFMlp`` variables -> ``models.hallucination.FtoFMlp``."""
    return names.to_torch(names.ftof_mlp(len(variables["params"]["xyz_mlp"])), variables)


def ftof_conv_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``FtoFConv`` variables -> ``models.hallucination.FtoFConv``."""
    return names.to_torch(names.ftof_conv(), variables)


def ftoi_mlp_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``FtoIMlp`` variables -> ``models.hallucination.FtoIMlp``."""
    return names.to_torch(names.ftoi_mlp(), variables)


def ftoi_conv_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``FtoIConv`` variables -> ``models.hallucination.FtoIConv``."""
    return names.to_torch(names.ftoi_conv(), variables)


def hrnet_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``HRNet`` variables -> ``models.hrnet.HRNet``."""
    return names.to_torch(names.hrnet(), variables)


def load_jax_params(backbone, params) -> None:
    """Load a JAX ``DualBackbone`` parameter pytree (numpy leaves) into a
    port ``DualBackbone`` in place."""
    backbone.vit.load_state_dict(vit_state_dict(params["vit"]))
    backbone.point.load_state_dict(point_mae_state_dict(params["point"]))
    backbone.to(backbone.device)
