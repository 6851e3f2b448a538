"""Reference torch checkpoints for the port.

``load_torch_checkpoint`` reads a ``.pth`` file to a ``{name: numpy
array}`` state dict, unwrapping ``model``, ``base_model`` or
``state_dict``; ``strip_pointmae_prefixes`` and ``strip_pointbert_prefixes``
are the reference's key remaps.  The port's modules carry the reference's
names (timm's, Point-MAE's, the fusion nets'), so such a state dict loads
into them directly: ``load_named`` takes exactly the keys a backbone module
has, as the JAX package's converters read exactly the keys they name, and
``load_reference_state`` loads a fusion net strictly, dropping by name the
keys of modules the net never runs.  The JAX package's layout of the same
arrays is each model's table in ``models.names``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

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
