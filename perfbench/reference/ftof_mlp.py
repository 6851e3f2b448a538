"""Plain FtoF MLP (the reference's ``HallucinationCrossModalityNetwork``,
``mlp_depth`` 1): LayerNorm, then three linear layers, each followed by an
exact GELU, the last one included."""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.no_grad()
def generate(sd, feature, side: str, ln_eps: float):
    """feature (..., D) of modality ``side`` -> the other modality's
    features, through the ``side`` stack."""
    x = F.layer_norm(feature, (feature.shape[-1],), sd[f"{side}_norm.weight"],
                     sd[f"{side}_norm.bias"], ln_eps)
    for fc in ("fc1", "fc2", "fc3"):
        name = f"{side}_mlp.mlp_module.0.{fc}"
        x = F.gelu(F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"]))
    return x
