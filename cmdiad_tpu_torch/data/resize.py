"""Host-side resizes of the data layer, without Pillow.

  * ``pil_bicubic_resize_u8``  Pillow's ``Image.resize(size, BICUBIC)`` of
    an 8-bit image, byte for byte (the RGB loader's resize);
  * ``pil_nearest_resize_u8``  Pillow's ``Image.resize(size, NEAREST)``,
    index for index (the ground-truth mask loader's resize);
  * ``nearest_resize_np``      the point-cloud loader's torch-style nearest
    rule, the JAX package's ``ops.pooling.nearest_resize_np``.

Sizes are an int (square) or ``(height, width)``.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# Pillow's fixed-point resampling precision for 8-bit images (Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _pair(size):
    return (size, size) if isinstance(size, int) else tuple(size)


def _bicubic(x: float) -> float:
    """Pillow's bicubic kernel, a = -0.5, support 2."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=None)
def _bicubic_taps(n_in: int, n_out: int):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for one
    axis: -> (first source index (n_out,), integer weights (n_out, k)).

    Taps are centred at (i + 0.5)·in/out with support 2·max(in/out, 1);
    each output's weights are normalised in float64, then rounded away
    from zero to 22-bit fixed point.
    """
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    weights = np.zeros((n_out, ksize), np.int32)
    for i in range(n_out):
        center = (i + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        first[i] = xmin
        weights[i, :xmax] = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
                             else int(0.5 + v * (1 << _PRECISION_BITS)) for v in w]
    return first, weights


def _bicubic_pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One of Pillow's two 8-bit passes along ``axis``: every output is
    ``clip((Σ w·x + 2^21) >> 22, 0, 255)`` in int32 arithmetic, as in
    Pillow (255 times the weights' absolute sum stays below 2^31)."""
    n_in = img.shape[axis]
    first, weights = _bicubic_taps(n_in, n_out)
    shape = [1] * img.ndim
    shape[axis] = n_out
    acc = np.full(img.shape[:axis] + (n_out,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(weights.shape[1]):
        # taps past an output's window have weight 0; clamp their index
        term = np.take(img, np.minimum(first + k, n_in - 1), axis=axis).astype(np.int32)
        term *= weights[:, k].reshape(shape)
        acc += term
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bicubic_resize_u8(img: np.ndarray, size) -> np.ndarray:
    """Pillow's ``Image.resize((w, h), Image.BICUBIC)`` of an (H, W) or
    (H, W, C) uint8 image: the horizontal pass first, into a uint8 image,
    then the vertical pass; an axis whose size does not change is not
    resampled."""
    oh, ow = _pair(size)
    out = np.asarray(img, np.uint8)
    if out.shape[1] != ow:
        out = _bicubic_pass(out, ow, axis=1)
    if out.shape[0] != oh:
        out = _bicubic_pass(out, oh, axis=0)
    return np.ascontiguousarray(out)


@functools.lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's nearest source index along one axis: the coordinate starts
    at 0.5·s and grows by s = in/out per output pixel in float64 (an
    accumulated sum, not (i + 0.5)·s), and the index is its integer part."""
    s = n_in / n_out
    x = 0.5 * s
    idx = np.zeros(n_out, np.int64)
    for i in range(n_out):
        idx[i] = int(x)
        x += s
    return idx


def pil_nearest_resize_u8(img: np.ndarray, size) -> np.ndarray:
    """Pillow's ``Image.resize((w, h), Image.NEAREST)`` of an (H, W[, C])
    uint8 image."""
    oh, ow = _pair(size)
    img = np.asarray(img)
    if img.shape[:2] == (oh, ow):
        return img.copy()
    return img[_nearest_index(img.shape[0], oh)][:, _nearest_index(img.shape[1], ow)]


def nearest_resize_np(a: np.ndarray, out_hw) -> np.ndarray:
    """Host-side torch-nearest resize for (H, W, C) numpy arrays (the
    organized point cloud's loader path): source index
    ``int(i · (in/out))`` in float64, clamped to the last row/column."""
    oh, ow = _pair(out_hw)
    ih, iw = a.shape[0], a.shape[1]
    ridx = np.minimum((np.arange(oh) * (ih / oh)).astype(np.int64), ih - 1)
    cidx = np.minimum((np.arange(ow) * (iw / ow)).astype(np.int64), iw - 1)
    return a[ridx][:, cidx]
