"""Reference torch checkpoints for the port.

``load_torch_checkpoint`` reads a ``.pth`` file to a ``{name: numpy
array}`` state dict, unwrapping ``model``, ``base_model`` or
``state_dict``; ``strip_pointmae_prefixes`` and ``strip_pointbert_prefixes``
are the reference's key remaps.  The port's modules carry the reference's
names (timm's, Point-MAE's, the fusion nets'), so such a state dict loads
into them directly: ``load_named`` takes exactly the keys a backbone module
has, as the JAX package's converters read exactly the keys they name, and
``load_reference_state`` loads a fusion net strictly, dropping by name the
keys of modules the net never runs.

The JAX-layout writers (``vit_from_timm`` ... ``hrnet_from_torch``) are
the JAX package's converters, kept here so that the port's
``convert-ckpt`` writes the same npz as the JAX CLI: pure renaming and
transposition, torch Linear (out, in) -> flax kernel (in, out), Conv2d
(out, in, kh, kw) -> (kh, kw, in, out), kernel-1 Conv1d -> Dense, BatchNorm
running statistics -> ``batch_stats``.  The fusion nets' come from their
name tables in ``models.names``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from cmdiad_tpu_torch.models import names

Array = np.ndarray
StateDict = Mapping[str, Array]


def torch_state_dict_to_numpy(sd) -> Dict[str, Array]:
    out = {}
    for k, v in sd.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Array]:
    """Read a torch ``.pth`` file to a numpy state dict on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("model", "base_model", "state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return torch_state_dict_to_numpy(ckpt)


def load_named(module: nn.Module, sd: StateDict) -> None:
    """Load the entries of ``sd`` that ``module`` has (a timm or Point-MAE
    checkpoint carries heads and decoder weights the backbone never runs);
    a missing entry raises, except BatchNorm's ``num_batches_tracked``."""
    own = module.state_dict()
    missing = sorted(k for k in own if k not in sd
                     and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:8]} ({len(missing)} entries)")
    module.load_state_dict({k: torch.as_tensor(np.asarray(sd[k])) if k in sd else v
                            for k, v in own.items()})


def load_reference_state(net: nn.Module, sd: StateDict) -> None:
    """Load a reference fusion-net state dict strictly, after dropping the
    keys under the net's ``unused_reference_keys`` prefixes."""
    drop = getattr(net, "unused_reference_keys", ())
    net.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
                         if not k.startswith(drop)})


def _dense(sd: StateDict, name: str, bias: bool = True) -> Dict[str, Array]:
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if bias and f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _conv2d(sd: StateDict, name: str, bias: bool = True) -> Dict[str, Array]:
    p = {"kernel": np.ascontiguousarray(
        sd[f"{name}.weight"].transpose(2, 3, 1, 0))}
    if bias and f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _conv1d_as_dense(sd: StateDict, name: str, bias: bool = True) -> Dict[str, Array]:
    w = sd[f"{name}.weight"]  # (out, in, 1)
    p = {"kernel": np.ascontiguousarray(w[:, :, 0].T)}
    if bias and f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _ln(sd: StateDict, name: str) -> Dict[str, Array]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _bn_params(sd: StateDict, name: str) -> Dict[str, Array]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _bn_stats(sd: StateDict, name: str) -> Dict[str, Array]:
    return {"mean": sd[f"{name}.running_mean"],
            "var": sd[f"{name}.running_var"]}


# ---------------------------------------------------------------------------
# ViT (timm naming)
# ---------------------------------------------------------------------------

def vit_from_timm(sd: StateDict, depth: int = 12) -> dict:
    """timm ViT state dict -> VisionTransformer variables.

    Handles DINO ViT-B/8-style plain blocks and DINOv2 extras (LayerScale
    ``ls{1,2}.gamma``, register tokens).  Register models carry timm's
    ``no_embed_class`` pos_embed (patch tokens only, no cls/reg rows) —
    passed through unchanged; the flax model applies the same convention.
    Cross-implementation parity vs a vendored timm-layout torch ViT:
    tests/test_vit_timm_provenance.py.
    """
    params = {
        "patch_embed": _conv2d(sd, "patch_embed.proj"),
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "norm": _ln(sd, "norm"),
    }
    if "reg_token" in sd:
        params["reg_token"] = sd["reg_token"]
    for i in range(depth):
        t = f"blocks.{i}"
        block = {
            "norm1": _ln(sd, f"{t}.norm1"),
            "attn": {
                "qkv": _dense(sd, f"{t}.attn.qkv"),
                "proj": _dense(sd, f"{t}.attn.proj"),
            },
            "norm2": _ln(sd, f"{t}.norm2"),
            "mlp": {
                "fc1": _dense(sd, f"{t}.mlp.fc1"),
                "fc2": _dense(sd, f"{t}.mlp.fc2"),
            },
        }
        if f"{t}.ls1.gamma" in sd:
            block["ls1"] = sd[f"{t}.ls1.gamma"]
            block["ls2"] = sd[f"{t}.ls2.gamma"]
        params[f"blocks_{i}"] = block
    return {"params": params}


# ---------------------------------------------------------------------------
# Point-MAE
# ---------------------------------------------------------------------------

def strip_pointmae_prefixes(sd: StateDict) -> Dict[str, Array]:
    """Reference key remap (models/models.py:286-296)."""
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        if k.startswith("MAE_encoder."):
            k = k[len("MAE_encoder."):]
        elif k.startswith("base_model."):
            k = k[len("base_model."):]
        out[k] = v
    return out


def strip_pointbert_prefixes(sd: StateDict) -> Dict[str, Array]:
    """Point-BERT key remap (models/models.py:299-309): keep transformer_q.*
    (except its cls_head) and base_model.* entries, prefixes stripped."""
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        if k.startswith("transformer_q") and not k.startswith(
                "transformer_q.cls_head"):
            out[k[len("transformer_q."):]] = v
        elif k.startswith("base_model."):
            out[k[len("base_model."):]] = v
    return out


def point_mae_from_torch(sd: StateDict, depth: int = 12) -> dict:
    """Point-MAE/Point-BERT state dict (prefix-stripped) -> PointTransformer
    variables.  Point-BERT checkpoints additionally carry cls_token/cls_pos
    and the reduce_dim projection (models/models.py:261-264)."""
    params = {
        "encoder": {
            "first_conv_0": _conv1d_as_dense(sd, "encoder.first_conv.0"),
            "first_conv_1": _bn_params(sd, "encoder.first_conv.1"),
            "first_conv_3": _conv1d_as_dense(sd, "encoder.first_conv.3"),
            "second_conv_0": _conv1d_as_dense(sd, "encoder.second_conv.0"),
            "second_conv_1": _bn_params(sd, "encoder.second_conv.1"),
            "second_conv_3": _conv1d_as_dense(sd, "encoder.second_conv.3"),
        },
        "pos_embed_0": _dense(sd, "pos_embed.0"),
        "pos_embed_2": _dense(sd, "pos_embed.2"),
        "norm": _ln(sd, "norm"),
    }
    if "cls_token" in sd:
        params["cls_token"] = sd["cls_token"]
        params["cls_pos"] = sd["cls_pos"]
    if "reduce_dim.weight" in sd:
        params["reduce_dim"] = _dense(sd, "reduce_dim")
    stats = {
        "encoder": {
            "first_conv_1": _bn_stats(sd, "encoder.first_conv.1"),
            "second_conv_1": _bn_stats(sd, "encoder.second_conv.1"),
        }
    }
    for i in range(depth):
        t = f"blocks.blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{t}.norm1"),
            # qkv has no bias in the reference module (qkv_bias=False,
            # models/models.py:143); a bias in the ckpt is dropped by its
            # strict=False load and therefore dropped here too.
            "attn_qkv": _dense(sd, f"{t}.attn.qkv", bias=False),
            "attn_proj": _dense(sd, f"{t}.attn.proj"),
            "norm2": _ln(sd, f"{t}.norm2"),
            "mlp_fc1": _dense(sd, f"{t}.mlp.fc1"),
            "mlp_fc2": _dense(sd, f"{t}.mlp.fc2"),
        }
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# MTFI fusion nets
# ---------------------------------------------------------------------------

def ftof_mlp_from_torch(sd: StateDict, mlp_depth: int = 1) -> dict:
    return names.to_flax(names.ftof_mlp(mlp_depth), sd)


def ftof_conv_from_torch(sd: StateDict) -> dict:
    return names.to_flax(names.ftof_conv(), sd)


def ftoi_mlp_from_torch(sd: StateDict) -> dict:
    return names.to_flax(names.ftoi_mlp(), sd)


def ftoi_conv_from_torch(sd: StateDict) -> dict:
    # reference declares self.norm but never uses it (:191,200-210) — dropped.
    return names.to_flax(names.ftoi_conv(), sd)


def hrnet_from_torch(sd: StateDict) -> dict:
    return names.to_flax(names.hrnet(), sd)
