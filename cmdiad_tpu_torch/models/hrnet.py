"""Truncated HRNet, the input-to-feature (ItoF) hallucination net, in PyTorch.

The JAX package's ``models/hrnet.py``: the reference HRNet as it runs (its
multi-branch stages are commented out upstream): a stride-4 stem of two 3x3
stride-2 convs with BN + ReLU, three layers of four ResNet bottlenecks
(128 planes, 512 out) at a quarter of the input's resolution, and a 1x1 head
with bias from 512 channels to ``out_dim``.  A (B, 224, 224, 3) image or
organized point cloud gives a (B, 56, 56, out_dim) feature grid.

Module names are the reference's (``conv1``, ``bn1``, ``layer{1..3}.{i}.
conv{1..3}``/``bn{1..3}``, ``layer1.0.downsample.{0,1}``, ``final_layer``).
BatchNorm runs on its running statistics (eps 1e-5), or in flax's training
mode with ``train=True``; ``loss`` is the training loss, the per-token L2
distance to the target patch features summed and divided by the batch
size.  Parameters stay float32; ``dtype`` is the compute type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmdiad_tpu_torch.models.hallucination import BN_EPS, batch_norm, conv2d, pairwise_loss


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4."""

    def __init__(self, inplanes: int, planes: int, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=BN_EPS)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, bias=False),
            nn.BatchNorm2d(planes * 4, eps=BN_EPS)) if downsample else None)

    def forward(self, x, train: bool = False):
        out = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        out = F.relu(batch_norm(self.bn2, conv2d(self.conv2, out), train))
        out = batch_norm(self.bn3, conv2d(self.conv3, out), train)
        residual = x
        if self.downsample is not None:
            residual = batch_norm(self.downsample[1], conv2d(self.downsample[0], x), train)
        return F.relu(out + residual)


class HRNet(nn.Module):
    """Stem + 3 x 4 bottlenecks + 1x1 head -> (B, H/4, W/4, out_dim)."""

    def __init__(self, out_dim: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.conv2 = nn.Conv2d(64, 128, 3, stride=2, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(128, eps=BN_EPS)
        for layer in (1, 2, 3):
            setattr(self, f"layer{layer}", nn.Sequential(*(
                Bottleneck(128 if layer == 1 and i == 0 else 512, 128,
                           downsample=layer == 1 and i == 0) for i in range(4))))
        self.final_layer = nn.Conv2d(512, out_dim, 1)

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        """image (B, H, W, 3) -> (B, H/4, W/4, out_dim)."""
        x = image.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        x = F.relu(batch_norm(self.bn2, conv2d(self.conv2, x), train))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, train)
        return conv2d(self.final_layer, x).permute(0, 2, 3, 1)

    def loss(self, image: torch.Tensor, feature_tokens: torch.Tensor,
             train: bool = True) -> torch.Tensor:
        """L2 feature-matching loss against (B, H/4 * W/4, out_dim) tokens."""
        h = self(image, train)
        return pairwise_loss(h.flatten(1, 2), feature_tokens, "l2")
