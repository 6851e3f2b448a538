"""One name table per model: torch key <-> flax path.

Each table lists, for every entry of a model's PyTorch state dict, the path
of the same array in the JAX package's flax variables and how its layout
changes: ``"linear"`` (torch (out, in) <-> flax Dense kernel (in, out)),
``"conv"`` (torch OIHW <-> flax HWIO), ``"conv1d"`` (a kernel-1 Conv1d's
(out, in, 1) <-> flax Dense kernel (in, out)) or ``None`` (same layout;
LayerNorm/BatchNorm ``weight`` <-> ``scale``, BatchNorm running
statistics <-> ``batch_stats`` ``mean``/``var``).  The backbones (``vit``,
``point_mae``) and the MTFI fusion nets each have one.  Every direction
comes from the table:

  * ``to_torch``: flax variables -> a state dict (the JAX package's
    parameters through ``models.backbone.load_jax_params``, and its npz
    through ``fusion_module_path``);
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


def _kernel(tk: str, fp: Tuple[str, ...], kind: str, bias: bool = True) -> Table:
    out = [(f"{tk}.weight", ("params", *fp, "kernel"), kind)]
    return out + ([(f"{tk}.bias", ("params", *fp, "bias"), None)] if bias else [])


def _norm(tk: str, fp: Tuple[str, ...]) -> Table:
    return [(f"{tk}.weight", ("params", *fp, "scale"), None),
            (f"{tk}.bias", ("params", *fp, "bias"), None)]


def _batchnorm(tk: str, fp: Tuple[str, ...]) -> Table:
    return _norm(tk, fp) + [(f"{tk}.running_mean", ("batch_stats", *fp, "mean"), None),
                            (f"{tk}.running_var", ("batch_stats", *fp, "var"), None)]


def _arrays(*keys: str) -> Table:
    return [(k, ("params", k), None) for k in keys]


def _block(tk: str, fp: str, nested: bool, qkv_bias: bool) -> Table:
    """A pre-LN block's ``norm{1,2}``, ``attn.{qkv,proj}`` and
    ``mlp.fc{1,2}``: the ViT's flax block nests them (``attn/qkv``),
    Point-MAE's joins them (``attn_qkv``)."""
    t = _norm(f"{tk}.norm1", (fp, "norm1")) + _norm(f"{tk}.norm2", (fp, "norm2"))
    for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
        path = (fp, *name.split(".")) if nested else (fp, name.replace(".", "_"))
        t += _kernel(f"{tk}.{name}", path, "linear", bias=qkv_bias or name != "attn.qkv")
    return t


def vit(depth: int = 12, layer_scale: bool = False, registers: bool = False,
        qkv_bias: bool = True) -> Table:
    """timm's ViT: ``patch_embed.proj``, ``cls_token``, ``pos_embed`` (and
    DINOv2's ``reg_token``), ``blocks.{i}`` <-> ``blocks_{i}`` (with
    DINOv2's LayerScale ``ls{1,2}.gamma`` <-> ``ls{1,2}``) and ``norm``."""
    t = _kernel("patch_embed.proj", ("patch_embed",), "conv")
    t += _arrays("cls_token", "pos_embed", *(("reg_token",) if registers else ()))
    for i in range(depth):
        t += _block(f"blocks.{i}", f"blocks_{i}", True, qkv_bias)
        if layer_scale:
            t += [(f"blocks.{i}.ls{j}.gamma", ("params", f"blocks_{i}", f"ls{j}"), None)
                  for j in (1, 2)]
    return t + _norm("norm", ("norm",))


def point_mae(depth: int = 12, point_bert: bool = False,
              qkv_bias: bool = False) -> Table:
    """Point-MAE's ``PointTransformer``: the encoder's kernel-1 convs
    ``{first,second}_conv.{0,3}`` <-> ``encoder/{first,second}_conv_{0,3}``
    and BatchNorms ``.1`` (statistics in ``batch_stats``), ``pos_embed.{0,2}``
    <-> ``pos_embed_{0,2}``, ``blocks.blocks.{i}`` <-> ``blocks_{i}`` and
    ``norm``; Point-BERT adds ``reduce_dim``, ``cls_token`` and ``cls_pos``.
    Without ``qkv_bias`` a checkpoint's qkv bias is dropped, as the
    reference's non-strict load drops it."""
    t: Table = []
    for conv in ("first_conv", "second_conv"):
        t += _kernel(f"encoder.{conv}.0", ("encoder", f"{conv}_0"), "conv1d")
        t += _batchnorm(f"encoder.{conv}.1", ("encoder", f"{conv}_1"))
        t += _kernel(f"encoder.{conv}.3", ("encoder", f"{conv}_3"), "conv1d")
    for j in (0, 2):
        t += _kernel(f"pos_embed.{j}", (f"pos_embed_{j}",), "linear")
    if point_bert:
        t += _kernel("reduce_dim", ("reduce_dim",), "linear") + _arrays("cls_token", "cls_pos")
    for i in range(depth):
        t += _block(f"blocks.blocks.{i}", f"blocks_{i}", False, qkv_bias)
    return t + _norm("norm", ("norm",))


def ftof_mlp(depth: int = 1) -> Table:
    """``FtoFMlp``: ``{side}_norm``, ``{side}_mlp.mlp_module.{d}.fc{1,2,3}``
    <-> ``{side}_mlp/block_{d}/fc{1,2,3}``."""
    t: Table = []
    for side in ("xyz", "rgb"):
        t += _norm(f"{side}_norm", (f"{side}_norm",))
        for d in range(depth):
            for fc in ("fc1", "fc2", "fc3"):
                t += _kernel(f"{side}_mlp.mlp_module.{d}.{fc}",
                             (f"{side}_mlp", f"block_{d}", fc), "linear")
    return t


def ftof_conv() -> Table:
    """``FtoFConv``: ``{side}_conv.{0,3,6,9}`` convs (no bias) <->
    ``conv_{0..3}``, ``{side}_conv.{1,4,7}`` BatchNorms <-> ``bn_{0..2}``."""
    t: Table = []
    for side in ("xyz", "rgb"):
        for j in range(4):
            t += _kernel(f"{side}_conv.{3 * j}", (f"{side}_conv", f"conv_{j}"), "conv",
                         bias=False)
        for j in range(3):
            t += _batchnorm(f"{side}_conv.{3 * j + 1}", (f"{side}_conv", f"bn_{j}"))
    return t


def ftoi_mlp() -> Table:
    """``FtoIMlp``: ``rgb_norm`` <-> ``norm``, ``mlp.{0,2,4,6}`` <->
    ``mlp_{0..3}``."""
    t = _norm("rgb_norm", ("norm",))
    for j in range(4):
        t += _kernel(f"mlp.{2 * j}", (f"mlp_{j}",), "linear")
    return t


def ftoi_conv() -> Table:
    """``FtoIConv``: ``conv{1..4}`` (the reference's unused ``norm`` has no
    entry)."""
    t: Table = []
    for j in (1, 2, 3, 4):
        t += _kernel(f"conv{j}", (f"conv{j}",), "conv")
    return t


def hrnet() -> Table:
    """``HRNet``: the stem, ``layer{1..3}.{i}`` <-> ``layer{l}_{i}`` (the
    downsample pair <-> ``down_conv``/``down_bn``) and ``final_layer``."""
    t: Table = []
    for i in (1, 2):
        t += _kernel(f"conv{i}", (f"conv{i}",), "conv", bias=False)
        t += _batchnorm(f"bn{i}", (f"bn{i}",))
    for layer in (1, 2, 3):
        for i in range(4):
            tk, fp = f"layer{layer}.{i}", f"layer{layer}_{i}"
            for j in (1, 2, 3):
                t += _kernel(f"{tk}.conv{j}", (fp, f"conv{j}"), "conv", bias=False)
                t += _batchnorm(f"{tk}.bn{j}", (fp, f"bn{j}"))
            if layer == 1 and i == 0:
                t += _kernel(f"{tk}.downsample.0", (fp, "down_conv"), "conv", bias=False)
                t += _batchnorm(f"{tk}.downsample.1", (fp, "down_bn"))
    return t + _kernel("final_layer", ("final_layer",), "conv")


def _to_torch_layout(kind: Optional[str], a: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return a.T
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "conv1d":
        return a.T[:, :, None]
    return a


def _to_flax_layout(kind: Optional[str], a: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return np.ascontiguousarray(a.T)
    if kind == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if kind == "conv1d":
        return np.ascontiguousarray(a[:, :, 0].T)
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
