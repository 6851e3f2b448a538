"""MTFI hallucination nets in PyTorch, inference forwards.

The JAX package's ``models/hallucination.py`` (the reference's
``models/hallucination_network.py``), channels-last at the boundary:

  FtoFMlp   per-direction LayerNorm + MlpModule stacks mapping 56²-grid
            patch features rgb <-> xyz (``generate``).
  FtoFConv  two conv3x3 + BN + ReLU (x3) + conv3x3 stacks on the 56² feature
            grid, 768 wide inside and out whatever the input width.
  FtoIMlp   LayerNorm + MLP in_dim -> 1152 -> 384 -> 96 -> 3 on the 56² grid,
            bicubic-upsampled to ``out_size``: an organized point cloud or an
            image from features.
  FtoIConv  conv in_dim -> 384, bicubic 56 -> ``out_size``, then convs
            384 -> 96 -> 32 -> 3 with ReLUs.

Module names are the reference's torch keys (``xyz_norm``,
``xyz_mlp.mlp_module.{d}.fc{1,2,3}``, ``xyz_conv.{0..9}``, ``rgb_norm`` and
``mlp.{0,2,4,6}``, ``conv{1..4}``), so a reference state dict loads with
``load_state_dict``.  As in the reference ``MlpBlock`` applies exact GELU
after every linear, the output one included; the hidden width is
``int(dim * 2.5)``.  LayerNorm epsilon is 1e-6 (the JAX package's ``nn.
LayerNorm`` names none, so flax's default).  BatchNorm runs on its running
statistics.  Parameters stay float32; ``dtype`` is the compute type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmdiad_tpu_torch.models.vit import layer_norm, linear
from cmdiad_tpu_torch.ops.pooling import bicubic_resize

LN_EPS = 1e-6
BN_EPS = 1e-5
GRID = 56
HIDDEN_RATIO = 2.5   # FtoF MLP hidden width int(dim * 2.5)
OUT_CHANNELS = 3     # FtoI nets regress xyz or RGB


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on NCHW in the input's dtype (parameters cast to it)."""
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, stride=conv.stride,
                    padding=conv.padding)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm on its running statistics, in the input's dtype."""
    return F.batch_norm(x, bn.running_mean.to(x.dtype), bn.running_var.to(x.dtype),
                        bn.weight.to(x.dtype), bn.bias.to(x.dtype), False, 0.0,
                        bn.eps)


def _grid(tokens: torch.Tensor) -> torch.Tensor:
    """(B, 3136, C) tokens -> (B, C, 56, 56)."""
    b, _, c = tokens.shape
    return tokens.reshape(b, GRID, GRID, c).permute(0, 3, 1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.permute(0, 2, 3, 1).flatten(1, 2)


class MlpBlock(nn.Module):
    """fc1 -> GELU -> fc2 -> GELU -> fc3 -> GELU."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, out)

    def forward(self, x):
        for fc in (self.fc1, self.fc2, self.fc3):
            x = F.gelu(linear(fc, x))
        return x


class MlpModule(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, depth: int = 1):
        super().__init__()
        self.mlp_module = nn.ModuleList(
            MlpBlock(dim if d == 0 else out, hidden, out) for d in range(depth))

    def forward(self, x):
        for block in self.mlp_module:
            x = block(x)
        return x


class FtoFMlp(nn.Module):
    """Feature-to-feature MLP net (``HallucinationCrossModalityNetwork``)."""

    def __init__(self, xyz_dim: int = 768, rgb_dim: int = 768,
                 mlp_depth: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.xyz_norm = nn.LayerNorm(xyz_dim, eps=LN_EPS)
        self.xyz_mlp = MlpModule(xyz_dim, int(xyz_dim * HIDDEN_RATIO), rgb_dim, mlp_depth)
        self.rgb_norm = nn.LayerNorm(rgb_dim, eps=LN_EPS)
        self.rgb_mlp = MlpModule(rgb_dim, int(rgb_dim * HIDDEN_RATIO), xyz_dim, mlp_depth)

    def generate(self, feature: torch.Tensor, out_type: str) -> torch.Tensor:
        """out_type 'xyz': rgb features -> xyz features through the *rgb*
        stack; 'rgb': xyz features -> rgb features through the *xyz* stack."""
        if out_type == "xyz":
            norm, mlp = self.rgb_norm, self.rgb_mlp
        elif out_type == "rgb":
            norm, mlp = self.xyz_norm, self.xyz_mlp
        else:
            raise ValueError(out_type)
        return mlp(layer_norm(norm, feature.to(torch.float32)).to(self.dtype))


def _conv_stack(in_dim: int) -> nn.Sequential:
    """conv3x3 (no bias) + BN + ReLU, three times, then conv3x3: 768 wide."""
    layers = []
    for i in range(3):
        layers += [nn.Conv2d(in_dim if i == 0 else 768, 768, 3, padding=1, bias=False),
                   nn.BatchNorm2d(768, eps=BN_EPS), nn.ReLU()]
    layers.append(nn.Conv2d(768, 768, 3, padding=1, bias=False))
    return nn.Sequential(*layers)


def _run_conv_stack(stack: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    for layer in stack:
        if isinstance(layer, nn.Conv2d):
            x = conv2d(layer, x)
        elif isinstance(layer, nn.BatchNorm2d):
            x = batch_norm(layer, x)
        else:
            x = F.relu(x)
    return x


class FtoFConv(nn.Module):
    """Feature-to-feature conv net (``HallucinationCrossModalityConv``)."""

    def __init__(self, xyz_dim: int = 768, rgb_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.xyz_conv = _conv_stack(xyz_dim)
        self.rgb_conv = _conv_stack(rgb_dim)

    def generate(self, feature: torch.Tensor, out_type: str) -> torch.Tensor:
        """(B, 3136, C) -> (B, 3136, 768); 'xyz' runs the rgb stack on rgb
        features, 'rgb' the xyz stack on xyz features."""
        if out_type not in ("xyz", "rgb"):
            raise ValueError(out_type)
        stack = self.rgb_conv if out_type == "xyz" else self.xyz_conv
        return _tokens(_run_conv_stack(stack, _grid(feature.to(self.dtype))))


class FtoIMlp(nn.Module):
    """Feature -> raw input MLP (``HallucinationRGBFeatureToXYZInputMLP``)."""

    def __init__(self, in_dim: int = 768, out_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_size = out_size
        self.rgb_norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.mlp = nn.Sequential(
            nn.Linear(in_dim, 1152), nn.GELU(), nn.Linear(1152, 384), nn.GELU(),
            nn.Linear(384, 96), nn.GELU(), nn.Linear(96, OUT_CHANNELS))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """(B, 3136, in_dim) -> (B, out_size, out_size, 3)."""
        x = layer_norm(self.rgb_norm, feature.to(torch.float32)).to(self.dtype)
        for i in (0, 2, 4):
            x = F.gelu(linear(self.mlp[i], x))
        x = linear(self.mlp[6], x)
        b, _, c = x.shape
        return bicubic_resize(x.reshape(b, GRID, GRID, c), self.out_size)


class FtoIConv(nn.Module):
    """Feature -> raw input conv net (``HallucinationFeatureToInputConv``).
    The reference also declares a ``norm`` it never runs; its keys are
    dropped when a reference state dict is loaded."""

    #: reference state-dict keys of modules the forward never runs
    unused_reference_keys = ("norm.",)

    def __init__(self, in_dim: int = 768, out_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_size = out_size
        self.conv1 = nn.Conv2d(in_dim, 384, 3, padding=1)
        self.conv2 = nn.Conv2d(384, 96, 3, padding=1)
        self.conv3 = nn.Conv2d(96, 32, 3, padding=1)
        self.conv4 = nn.Conv2d(32, OUT_CHANNELS, 3, padding=1)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """(B, 3136, in_dim) -> (B, out_size, out_size, 3)."""
        x = conv2d(self.conv1, _grid(feature.to(self.dtype)))
        x = bicubic_resize(x.permute(0, 2, 3, 1), self.out_size).permute(0, 3, 1, 2)
        x = F.relu(conv2d(self.conv2, x))
        x = F.relu(conv2d(self.conv3, x))
        return conv2d(self.conv4, x).permute(0, 2, 3, 1)
