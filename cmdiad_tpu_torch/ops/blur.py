"""PIL-compatible Gaussian blur of score maps.

The reference blurs each 224² score map with
``ImageFilter.GaussianBlur(radius=4)``: per axis, three passes of an
extended box filter (Gwosdek et al.) with edge replication.  In float mode
(the default) the three clamped passes compose into one fixed (H, H)
matrix per axis, built once in numpy and applied as two matrix products.
``quantized_knn_gaussian_blur`` is the bit-exact uint8 mode
(``Config.quantized_blur``), elementwise integer work.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cmdiad_tpu_torch import tracing


def _extended_box_kernel(sigma2: float) -> np.ndarray:
    """1-D extended box kernel for one pass: integer radius l plus
    fractional edge taps so the kernel variance equals ``sigma2``."""
    big_l = np.sqrt(12.0 * sigma2 + 1.0)
    l = int(np.floor((big_l - 1.0) / 2.0))
    alpha = (sigma2 * (2 * l + 1) - l * (l + 1) * (2 * l + 1) / 3.0) / (
        2.0 * ((l + 1) ** 2 - sigma2))
    c = 1.0 / (2 * l + 1 + 2 * alpha)
    k = np.full(2 * l + 3, c, np.float64)
    k[0] = k[-1] = alpha * c
    return k


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, radius: float, passes: int = 3) -> np.ndarray:
    """(n, n) matrix of ``passes`` clamped extended-box passes along one axis."""
    k = _extended_box_kernel(radius * radius / passes)
    r = len(k) // 2
    m = np.zeros((n, n), np.float64)
    for i in range(n):
        for t, w in enumerate(k):
            j = min(max(i + t - r, 0), n - 1)  # clamp = edge replication
            m[i, j] += w
    return np.linalg.matrix_power(m, passes).astype(np.float32)


def pil_gaussian_blur(img: torch.Tensor, radius: float = 4.0) -> torch.Tensor:
    """Blur the trailing two axes of ``img`` ((..., H, W)) like PIL; the
    matrices stay on the device (``tracing.constant``)."""
    mh = tracing.constant(img.device, img.dtype, _blur_matrix, img.shape[-2], radius)
    mw = tracing.constant(img.device, img.dtype, _blur_matrix, img.shape[-1], radius)
    out = torch.einsum("oh,...hw->...ow", mh, img)
    return torch.einsum("ow,...hw->...ho", mw, out)


def knn_gaussian_blur(score_map: torch.Tensor, radius: float = 4.0) -> torch.Tensor:
    """Reference KNNGaussianBlur on (..., H, W) maps: max-normalise each map,
    blur, un-normalise."""
    mx = torch.amax(score_map, dim=(-2, -1), keepdim=True)
    safe = torch.where(mx == 0, torch.ones_like(mx), mx)
    return pil_gaussian_blur(score_map / safe, radius) * safe


# ---------------------------------------------------------------------------
# Bit-exact quantised mode (``Config.quantized_blur``)
# ---------------------------------------------------------------------------
#
# The reference's KNNGaussianBlur does not blur floats: torchvision's
# ToPILImage quantises the max-normalised map to uint8 (``mul(255).byte()``,
# truncation) and Pillow then runs its integer box blur on the mode-'L'
# image: per axis, three passes of a moving-window sum scaled by 24.24
# fixed-point weights, rounded back to uint8 after every pass (Pillow
# src/libImaging/BoxBlur.c), horizontal passes first.  The functions below
# repeat that integer arithmetic in int64, where ``acc * ww + far * fw``
# (at most 255 * 2^24) cannot overflow, so they give Pillow's bytes.

def _pillow_box_params(radius: float, passes: int = 3):
    """Pillow's _gaussian_blur_radius and per-pass fixed-point weights:
    (r, ww, fw) = integer window radius, 24.24 weight of the 2r+1 full taps
    and of each of the two fractional edge taps."""
    sigma2 = radius * radius / passes
    big_l = math.sqrt(12.0 * sigma2 + 1.0)
    l = math.floor((big_l - 1.0) / 2.0)
    a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2) / (
        6 * (sigma2 - (l + 1) ** 2))
    box_radius = l + a
    r = int(box_radius)
    # C: ww = (UINT32)((1 << 24) / (floatRadius * 2 + 1)), in float32
    ww = int(np.float32(1 << 24) / np.float32(box_radius * 2 + 1))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    return r, ww, fw


def _box_pass_u8(x: torch.Tensor, r: int, ww: int, fw: int) -> torch.Tensor:
    """One Pillow box pass along the last axis of (..., W) int64 values
    in [0, 255]; returns int64 values in [0, 255]."""
    w = x.shape[-1]
    pad = torch.cat([x[..., :1].expand(*x.shape[:-1], r + 1), x,
                     x[..., -1:].expand(*x.shape[:-1], r + 1)], dim=-1)
    # out[i] sums pad[i+1 .. i+2r+1]; the far taps are pad[i], pad[i+2r+2]
    acc = pad[..., 1:1 + w]
    for t in range(2, 2 * r + 2):
        acc = acc + pad[..., t:t + w]
    bulk = acc * ww + (pad[..., 0:w] + pad[..., 2 * r + 2:2 * r + 2 + w]) * fw
    return (bulk + (1 << 23)) >> 24


def pil_gaussian_blur_u8(img_u8: torch.Tensor, radius: float = 4.0,
                         passes: int = 3) -> torch.Tensor:
    """Pillow's GaussianBlur of (..., H, W) uint8 ('L'-mode) images, bit
    for bit: ``passes`` horizontal passes, then ``passes`` vertical."""
    r, ww, fw = _pillow_box_params(radius, passes)
    x = img_u8.to(torch.int64)
    for _ in range(passes):
        x = _box_pass_u8(x, r, ww, fw)
    x = x.transpose(-1, -2)
    for _ in range(passes):
        x = _box_pass_u8(x, r, ww, fw)
    return x.transpose(-1, -2).to(torch.uint8)


def quantized_knn_gaussian_blur(score_map: torch.Tensor,
                                radius: float = 4.0) -> torch.Tensor:
    """The reference KNNGaussianBlur bit for bit on (..., H, W) maps: divide
    each map by its own maximum, truncate ``* 255`` to uint8, Pillow's
    integer blur, ``/ 255``, multiply the maximum back."""
    s = score_map.to(torch.float32)
    mx = torch.amax(s, dim=(-2, -1), keepdim=True)
    safe = torch.where(mx == 0, torch.ones_like(mx), mx)
    u8 = (s / safe * 255.0).to(torch.uint8)          # truncation, as .byte()
    # a tensor divisor: CUDA divides by a Python scalar as a multiplication
    # by its reciprocal, which is not the correctly rounded quotient
    return (pil_gaussian_blur_u8(u8, radius).to(torch.float32)
            / tracing.constant(s.device, s.dtype, float, 255.0) * safe)
