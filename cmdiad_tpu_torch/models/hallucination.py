"""MTFI hallucination nets in PyTorch, with their training losses.

The JAX package's ``models/hallucination.py`` (the reference's
``models/hallucination_network.py``), channels-last at the boundary:

  FtoFMlp   per-direction LayerNorm + MlpModule stacks mapping 56²-grid
            patch features rgb <-> xyz (``generate``).
  FtoFConv  two conv3x3 + BN + ReLU (x3) + conv3x3 stacks on the 56² feature
            grid, 768 wide inside and out whatever the input width.
  FtoIMlp   LayerNorm + MLP in_dim -> 1152 -> 384 -> 96 -> out_channels on
            the 56² grid, bicubic-upsampled to ``out_size``: an organized
            point cloud or an image (3 channels) or a depth map (1) from
            features.
  FtoIConv  conv in_dim -> 384, bicubic 56 -> ``out_size``, then convs
            384 -> 96 -> 32 -> out_channels with ReLUs.

The training losses are the JAX package's (the reference's): FtoFMlp's
``forward`` gives both directions' ``cos_dist``, ``l2`` or ``smooth_l1``
losses, FtoFConv's ``forward`` their l2 losses (optionally on sigmoids)
with BatchNorm in training mode, the FtoI nets' ``loss`` the per-pixel L2
distance to the target image; every loss sums over all but the batch axis
and divides by the batch size, in at least float32.

Module names are the reference's torch keys (``xyz_norm``,
``xyz_mlp.mlp_module.{d}.fc{1,2,3}``, ``xyz_conv.{0..9}``, ``rgb_norm`` and
``mlp.{0,2,4,6}``, ``conv{1..4}``), so a reference state dict loads with
``load_state_dict``.  As in the reference ``MlpBlock`` applies exact GELU
after every linear, the output one included; the hidden width is
``int(dim * 2.5)``.  LayerNorm epsilon is 1e-6 (the JAX package's ``nn.
LayerNorm`` names none, so flax's default).  BatchNorm runs on its running
statistics, or with ``train=True`` as flax's does in training (see
``batch_norm``), its moments over every rank's batch after
``sync_batch_norm``.  Parameters stay float32; ``dtype`` is the compute type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmdiad_tpu_torch.models.vit import layer_norm, linear
from cmdiad_tpu_torch.ops.pooling import bicubic_resize
from cmdiad_tpu_torch.parallel.mesh import all_reduce_sum

LN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.9    # flax's: running = 0.9 * running + 0.1 * batch
GRID = 56
HIDDEN_RATIO = 2.5   # FtoF MLP hidden width int(dim * 2.5)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on NCHW in the input's dtype (parameters cast to it)."""
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, stride=conv.stride,
                    padding=conv.padding)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """BatchNorm of an NCHW tensor, returned in the input's dtype.

    Eval mode normalises with the running statistics.  ``train=True``
    follows flax's ``BatchNorm`` rather than torch's: the batch mean and the
    *biased* variance E[x²]−E[x]², both in at least float32 and the
    variance clipped at 0, normalise the batch, and the running statistics
    move to ``0.9 * running + 0.1 * batch`` with that same variance (torch
    would fold in the unbiased one).  After ``sync_batch_norm`` the moments
    are those of the global batch, every rank's block of it: (sum, sum of
    squares, count) are summed over the ranks with a sum whose backward
    sums the gradients over the ranks too, as a jitted mean over a batch
    sharded across devices is in the JAX package.
    """
    if not train:
        return F.batch_norm(x, bn.running_mean.to(x.dtype), bn.running_var.to(x.dtype),
                            bn.weight.to(x.dtype), bn.bias.to(x.dtype), False, 0.0,
                            bn.eps)
    xf = _at_least_f32(x)
    group = getattr(bn, "sync_group", None)
    if group is None:
        mean, ex2 = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
    else:
        c = xf.shape[1]
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                                         xf.new_full((1,), xf.numel() // c)]), group)
        mean, ex2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    with torch.no_grad():
        for running, batch in ((bn.running_mean, mean), (bn.running_var, var)):
            running.copy_(BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def sync_batch_norm(net: nn.Module, group) -> None:
    """Take every training BatchNorm moment of ``net`` over the ranks of
    the process ``group`` (None: over this rank's batch alone)."""
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.sync_group = group


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch ``nn.SmoothL1Loss(reduction='none')``, beta 1."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def pairwise_loss(hallu: torch.Tensor, real: torch.Tensor, dist_method: str,
                  dim: int = 2) -> torch.Tensor:
    """The reference's distillation loss, in (at least) float32: the per-token
    ``cos_dist`` (1 - cosine, its denominator clamped at 1e-30), ``l2``
    distance or element-wise ``smooth_l1``, summed over all but the batch
    axis and divided by the batch size."""
    hallu, real = _at_least_f32(hallu), _at_least_f32(real)
    if dist_method == "cos_dist":
        num = (hallu * real).sum(dim)
        den = torch.clamp_min(torch.linalg.vector_norm(hallu, dim=dim)
                              * torch.linalg.vector_norm(real, dim=dim), 1e-30)
        per = 1.0 - num / den
    elif dist_method == "l2":
        per = torch.linalg.vector_norm(hallu - real, dim=dim)
    elif dist_method == "smooth_l1":
        per = smooth_l1(hallu, real)
    else:
        raise ValueError(dist_method)
    return per.sum() / per.shape[0]


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

    def forward(self, xyz: torch.Tensor, rgb: torch.Tensor,
                dist_method: str = "cos_dist"):
        """Both directions' distillation losses -> (loss_xyz, loss_rgb):
        xyz features hallucinated from rgb against the real ones, and the
        other way round."""
        return (pairwise_loss(self.generate(rgb, "xyz"), xyz, dist_method),
                pairwise_loss(self.generate(xyz, "rgb"), rgb, dist_method))


def _conv_stack(in_dim: int) -> nn.Sequential:
    """conv3x3 (no bias) + BN + ReLU, three times, then conv3x3: 768 wide."""
    layers = []
    for i in range(3):
        layers += [nn.Conv2d(in_dim if i == 0 else 768, 768, 3, padding=1, bias=False),
                   nn.BatchNorm2d(768, eps=BN_EPS), nn.ReLU()]
    layers.append(nn.Conv2d(768, 768, 3, padding=1, bias=False))
    return nn.Sequential(*layers)


def _run_conv_stack(stack: nn.Sequential, x: torch.Tensor,
                    train: bool = False) -> torch.Tensor:
    for layer in stack:
        if isinstance(layer, nn.Conv2d):
            x = conv2d(layer, x)
        elif isinstance(layer, nn.BatchNorm2d):
            x = batch_norm(layer, x, train)
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

    def generate(self, feature: torch.Tensor, out_type: str,
                 train: bool = False) -> torch.Tensor:
        """(B, 3136, C) -> (B, 3136, 768); 'xyz' runs the rgb stack on rgb
        features, 'rgb' the xyz stack on xyz features."""
        if out_type not in ("xyz", "rgb"):
            raise ValueError(out_type)
        stack = self.rgb_conv if out_type == "xyz" else self.xyz_conv
        return _tokens(_run_conv_stack(stack, _grid(feature.to(self.dtype)), train))

    def forward(self, xyz: torch.Tensor, rgb: torch.Tensor, sigmoid: bool = False,
                train: bool = True):
        """Both directions' l2 losses -> (loss_xyz, loss_rgb), on the
        sigmoids of hallucinated and real features with ``sigmoid``;
        ``train`` runs BatchNorm in training mode."""
        xyz_h, rgb_h = self.generate(rgb, "xyz", train), self.generate(xyz, "rgb", train)
        if sigmoid:
            xyz_h, xyz, rgb_h, rgb = (torch.sigmoid(_at_least_f32(t))
                                      for t in (xyz_h, xyz, rgb_h, rgb))
        return pairwise_loss(xyz_h, xyz, "l2"), pairwise_loss(rgb_h, rgb, "l2")


class FtoIMlp(nn.Module):
    """Feature -> raw input MLP (``HallucinationRGBFeatureToXYZInputMLP``)."""

    def __init__(self, in_dim: int = 768, out_channels: int = 3, out_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_size = out_size
        self.rgb_norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.mlp = nn.Sequential(
            nn.Linear(in_dim, 1152), nn.GELU(), nn.Linear(1152, 384), nn.GELU(),
            nn.Linear(384, 96), nn.GELU(), nn.Linear(96, out_channels))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """(B, 3136, in_dim) -> (B, out_size, out_size, out_channels)."""
        x = layer_norm(self.rgb_norm, feature.to(torch.float32)).to(self.dtype)
        for i in (0, 2, 4):
            x = F.gelu(linear(self.mlp[i], x))
        x = linear(self.mlp[6], x)
        b, _, c = x.shape
        return bicubic_resize(x.reshape(b, GRID, GRID, c), self.out_size)

    def loss(self, feature: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return input_loss(self(feature), target)


class FtoIConv(nn.Module):
    """Feature -> raw input conv net (``HallucinationFeatureToInputConv``).
    The reference also declares a ``norm`` it never runs; its keys are
    dropped when a reference state dict is loaded."""

    #: reference state-dict keys of modules the forward never runs
    unused_reference_keys = ("norm.",)

    def __init__(self, in_dim: int = 768, out_channels: int = 3, out_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_size = out_size
        self.conv1 = nn.Conv2d(in_dim, 384, 3, padding=1)
        self.conv2 = nn.Conv2d(384, 96, 3, padding=1)
        self.conv3 = nn.Conv2d(96, 32, 3, padding=1)
        self.conv4 = nn.Conv2d(32, out_channels, 3, padding=1)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """(B, 3136, in_dim) -> (B, out_size, out_size, out_channels)."""
        x = conv2d(self.conv1, _grid(feature.to(self.dtype)))
        x = bicubic_resize(x.permute(0, 2, 3, 1), self.out_size).permute(0, 3, 1, 2)
        x = F.relu(conv2d(self.conv2, x))
        x = F.relu(conv2d(self.conv3, x))
        return conv2d(self.conv4, x).permute(0, 2, 3, 1)

    def loss(self, feature: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return input_loss(self(feature), target)


def input_loss(hallu: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """FtoI loss: the per-pixel L2 distance over channels, summed and
    divided by the batch size, in (at least) float32; a 1-channel (depth)
    output broadcasts against a 3-channel target, as in the JAX package."""
    per = torch.linalg.vector_norm(_at_least_f32(hallu) - _at_least_f32(target), dim=-1)
    return per.sum() / per.shape[0]
