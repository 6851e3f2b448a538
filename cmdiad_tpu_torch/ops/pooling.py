"""Torch-compatible pooling / resize as separable matrix products.

Each resize is a pair of small dense matrices applied along H then W of a
channels-last (..., H, W, C) tensor, the same matrices the JAX package
builds, so both packages compute the same linear maps:

  * ``adaptive_avg_pool``          nn.AdaptiveAvgPool2d
  * ``bilinear_resize``            F.interpolate(mode='bilinear',
                                   align_corners=False)
  * ``bicubic_resize``             F.interpolate(mode='bicubic',
                                   align_corners=False) itself
  * ``avg3x3_then_adaptive_pool``  nn.AvgPool2d(3, stride=1) then
                                   AdaptiveAvgPool2d, as one operator
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cmdiad_tpu_torch import tracing


@functools.lru_cache(maxsize=None)
def _adaptive_avg_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic matrix of AdaptiveAvgPool1d bins:
    bin i covers [floor(i*In/Out), ceil((i+1)*In/Out))."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -((-(i + 1) * n_in) // n_out)  # ceil
        m[i, start:end] = 1.0 / (end - start)
    return m


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of F.interpolate(mode='bilinear') along one
    axis: half-pixel mapping src = (dst + 0.5) * In/Out - 0.5 with the
    source index clamped at the borders."""
    scale = n_in / n_out
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    m = np.zeros((n_out, n_in), np.float64)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    lo = np.clip(i0, 0, n_in - 1)
    hi = np.clip(i0 + 1, 0, n_in - 1)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pool3x3_adaptive_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D operator for AdaptiveAvgPool(n_in-2 -> n_out) after a 3-wide
    stride-1 VALID average: one banded (n_out, n_in) matrix per axis."""
    a3 = np.zeros((n_in - 2, n_in), np.float32)
    idx = np.arange(n_in - 2)
    for t in range(3):
        a3[idx, idx + t] = 1.0 / 3.0
    return (_adaptive_avg_matrix(n_in - 2, n_out) @ a3).astype(np.float32)


def _apply_separable(x: torch.Tensor, build, out_hw) -> torch.Tensor:
    """Apply ``build``'s (Ho, Hi) and (Wo, Wi) matrices to the H/W axes of
    (..., H, W, C); the matrices stay on the device (``tracing.constant``)."""
    oh, ow = _pair(out_hw)
    mh_t = tracing.constant(x.device, x.dtype, build, x.shape[-3], oh)
    mw_t = tracing.constant(x.device, x.dtype, build, x.shape[-2], ow)
    x = torch.einsum("oh,...hwc->...owc", mh_t, x)
    return torch.einsum("ow,...hwc->...hoc", mw_t, x)


def _pair(out_hw):
    return (out_hw, out_hw) if isinstance(out_hw, int) else tuple(out_hw)


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d for channels-last inputs."""
    return _apply_separable(x, _adaptive_avg_matrix, out_hw)


def bilinear_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False), channels-last."""
    return _apply_separable(x, _bilinear_matrix, out_hw)


def bicubic_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """F.interpolate(mode='bicubic', align_corners=False) on a channels-last
    (B, H, W, C) tensor: Keys' kernel with A = -0.75 and edge-clamped taps,
    the separable band matrices of the JAX package's ``bicubic_resize``.
    Computed in at least float32, returned in the input's dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2).to(torch.promote_types(x.dtype, torch.float32)),
                      size=_pair(out_hw), mode="bicubic", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def avg3x3_then_adaptive_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """3x3 stride-1 VALID average, then adaptive average pooling to
    ``out_hw``, as one separable matrix pair (the (H-2, W-2) intermediate
    never exists)."""
    return _apply_separable(x, _pool3x3_adaptive_matrix, out_hw)
