"""One name table per MTFI fusion net: torch key <-> flax path.

Each table lists, for every entry of a net's PyTorch state dict, the path
of the same array in the JAX package's flax variables and how its layout
changes: ``"linear"`` (torch (out, in) <-> flax Dense kernel (in, out)),
``"conv"`` (torch OIHW <-> flax HWIO) or ``None`` (same layout;
LayerNorm/BatchNorm ``weight`` <-> ``scale``, BatchNorm running
statistics <-> ``batch_stats`` ``mean``/``var``).  Every direction comes
from the table:

  * ``to_torch``: flax variables -> a state dict (``models.bridge``, and
    the JAX package's npz through ``fusion_module_path``);
  * ``to_flax``: a state dict -> flax variables (``convert-ckpt``, and the
    trainer's checkpoints: ``params``, ``batch_stats`` and the optimizer's
    per-parameter trees, which share the ``params`` paths).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Entry = Tuple[str, Tuple[str, ...], Optional[str]]
Table = List[Entry]


def _linear(tk: str, fp: Tuple[str, ...], bias: bool = True) -> Table:
    out = [(f"{tk}.weight", ("params", *fp, "kernel"), "linear")]
    return out + ([(f"{tk}.bias", ("params", *fp, "bias"), None)] if bias else [])


def _conv(tk: str, fp: Tuple[str, ...], bias: bool = True) -> Table:
    out = [(f"{tk}.weight", ("params", *fp, "kernel"), "conv")]
    return out + ([(f"{tk}.bias", ("params", *fp, "bias"), None)] if bias else [])


def _norm(tk: str, fp: Tuple[str, ...]) -> Table:
    return [(f"{tk}.weight", ("params", *fp, "scale"), None),
            (f"{tk}.bias", ("params", *fp, "bias"), None)]


def _batchnorm(tk: str, fp: Tuple[str, ...]) -> Table:
    return _norm(tk, fp) + [(f"{tk}.running_mean", ("batch_stats", *fp, "mean"), None),
                            (f"{tk}.running_var", ("batch_stats", *fp, "var"), None)]


def ftof_mlp(depth: int = 1) -> Table:
    """``FtoFMlp``: ``{side}_norm``, ``{side}_mlp.mlp_module.{d}.fc{1,2,3}``
    <-> ``{side}_mlp/block_{d}/fc{1,2,3}``."""
    t: Table = []
    for side in ("xyz", "rgb"):
        t += _norm(f"{side}_norm", (f"{side}_norm",))
        for d in range(depth):
            for fc in ("fc1", "fc2", "fc3"):
                t += _linear(f"{side}_mlp.mlp_module.{d}.{fc}",
                             (f"{side}_mlp", f"block_{d}", fc))
    return t


def ftof_conv() -> Table:
    """``FtoFConv``: ``{side}_conv.{0,3,6,9}`` convs (no bias) <->
    ``conv_{0..3}``, ``{side}_conv.{1,4,7}`` BatchNorms <-> ``bn_{0..2}``."""
    t: Table = []
    for side in ("xyz", "rgb"):
        for j in range(4):
            t += _conv(f"{side}_conv.{3 * j}", (f"{side}_conv", f"conv_{j}"), bias=False)
        for j in range(3):
            t += _batchnorm(f"{side}_conv.{3 * j + 1}", (f"{side}_conv", f"bn_{j}"))
    return t


def ftoi_mlp() -> Table:
    """``FtoIMlp``: ``rgb_norm`` <-> ``norm``, ``mlp.{0,2,4,6}`` <->
    ``mlp_{0..3}``."""
    t = _norm("rgb_norm", ("norm",))
    for j in range(4):
        t += _linear(f"mlp.{2 * j}", (f"mlp_{j}",))
    return t


def ftoi_conv() -> Table:
    """``FtoIConv``: ``conv{1..4}`` (the reference's unused ``norm`` has no
    entry)."""
    t: Table = []
    for j in (1, 2, 3, 4):
        t += _conv(f"conv{j}", (f"conv{j}",))
    return t


def hrnet() -> Table:
    """``HRNet``: the stem, ``layer{1..3}.{i}`` <-> ``layer{l}_{i}`` (the
    downsample pair <-> ``down_conv``/``down_bn``) and ``final_layer``."""
    t: Table = []
    for i in (1, 2):
        t += _conv(f"conv{i}", (f"conv{i}",), bias=False)
        t += _batchnorm(f"bn{i}", (f"bn{i}",))
    for layer in (1, 2, 3):
        for i in range(4):
            tk, fp = f"layer{layer}.{i}", f"layer{layer}_{i}"
            for j in (1, 2, 3):
                t += _conv(f"{tk}.conv{j}", (fp, f"conv{j}"), bias=False)
                t += _batchnorm(f"{tk}.bn{j}", (fp, f"bn{j}"))
            if layer == 1 and i == 0:
                t += _conv(f"{tk}.downsample.0", (fp, "down_conv"), bias=False)
                t += _batchnorm(f"{tk}.downsample.1", (fp, "down_bn"))
    return t + _conv("final_layer", ("final_layer",))


def _to_torch_layout(kind: Optional[str], a: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return a.T
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    return a


def _to_flax_layout(kind: Optional[str], a: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return np.ascontiguousarray(a.T)
    if kind == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    return a


def to_torch(table: Sequence[Entry], variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables -> a float32 state dict (BatchNorm's
    ``num_batches_tracked`` set to 0), so that ``load_state_dict`` is
    strict; only the entries of the collections ``variables`` holds
    (``to_torch(t, {"params": g})`` maps a per-parameter tree back)."""
    sd: Dict[str, torch.Tensor] = {}
    for tk, path, kind in table:
        if path[0] not in variables:
            continue
        node = variables
        for p in path:
            node = node[p]
        sd[tk] = torch.from_numpy(np.array(_to_torch_layout(kind, np.asarray(node)),
                                           np.float32))
        if tk.endswith(".running_mean"):
            sd[tk[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
    return sd


def to_flax(table: Sequence[Entry], arrays: Mapping,
            collections: Sequence[str] = ("params", "batch_stats")) -> dict:
    """A state dict (numpy arrays or tensors) -> nested flax variables,
    with only the table's entries in ``collections``; ``to_flax(t, g,
    ("params",))["params"]`` is the tree of a per-parameter map ``g``
    (gradients, Adam's moments)."""
    out: dict = {}
    for tk, path, kind in table:
        if path[0] not in collections:
            continue
        a = arrays[tk]
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax_layout(kind, a)
    return out
