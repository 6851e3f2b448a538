"""Segmentation-map heatmaps, drawn without matplotlib.

The JAX package's ``utils/heatmap.py`` renders each saved score map with
matplotlib (input, ground truth in ``gray``, score map in ``jet``, titles
and colourbars).  The card machine has no matplotlib, so this module draws
the panels itself and writes them with ``data.png``: each panel is the
image ``imshow`` would colour, one pixel a value, normalised to its own
min/max as ``matplotlib.colors.Normalize()`` does (in the data's float
type; integer data as float32 or float64 by matplotlib's rule) and looked
up in a copy of matplotlib's 256-entry ``jet`` or ``gray`` table.  The
panels stand side by side on white, 8 pixels apart, without the JAX
figure's titles and colourbars (no font renderer here).  Host code.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Optional

import numpy as np

from cmdiad_tpu_torch.data import png

N = 256
GAP = 8
# matplotlib/_cm.py's segment data: (x, value left of x, value right of x)
_SEGMENTS = {
    "jet": {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
            "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
                      (0.91, 0, 0), (1.0, 0, 0)),
            "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0))},
    "gray": {c: ((0.0, 0, 0), (1.0, 1, 1)) for c in ("red", "green", "blue")},
}


def _channel_table(data) -> np.ndarray:
    """matplotlib's ``_create_lookup_table(N, data)`` at gamma 1."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (N - 1), a[:, 1], a[:, 2]
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def colour_table(name: str) -> np.ndarray:
    """(N, 3) uint8 table of colormap ``name`` ('jet' or 'gray'), as
    ``cmap(..., bytes=True)`` takes it."""
    lut = np.stack([_channel_table(_SEGMENTS[name][c]) for c in ("red", "green", "blue")], 1)
    return (lut * 255).astype(np.uint8)


def normalize(x: np.ndarray) -> np.ndarray:
    """``matplotlib.colors.Normalize()(x)``: (x - min) / (max - min) in
    x's float type (integers and bools of at most 2 bytes as float32,
    wider ones as float64), all zeros when min == max."""
    x = np.asarray(x)
    dtype = x.dtype
    if np.issubdtype(dtype, np.integer) or dtype == np.bool_:
        dtype = np.promote_types(dtype, np.float32)
    out = x.astype(dtype, copy=True)
    vmin, vmax = out.min(), out.max()
    if vmin == vmax:
        out.fill(0)
    else:
        out -= vmin
        out /= (vmax - vmin)
    return out


def colourize(x: np.ndarray, name: str) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8: ``cmap(Normalize()(x),
    bytes=True)[..., :3]`` for cmap ``name``; NaN is black."""
    v = normalize(x) * N
    v[v == N] = N - 1
    bad = np.isnan(v)
    idx = np.clip(np.where(bad, 0, v).astype(int), 0, N - 1)
    out = colour_table(name)[idx]
    out[bad] = 0
    return out


def render_heatmap(score_map: np.ndarray, out_path: str,
                   rgb: Optional[np.ndarray] = None,
                   gt: Optional[np.ndarray] = None) -> str:
    """Write the panels (rgb as it is, gt in gray, the score map in jet)
    side by side to the PNG ``out_path``."""
    panels = []
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError(f"rgb must be (H, W, 3) uint8, not {rgb.dtype} {rgb.shape}")
        panels.append(rgb)
    if gt is not None:
        panels.append(colourize(np.asarray(gt), "gray"))
    panels.append(colourize(np.asarray(score_map), "jet"))
    h = max(p.shape[0] for p in panels)
    w = sum(p.shape[1] for p in panels) + GAP * (len(panels) - 1)
    canvas = np.full((h, w, 3), 255, np.uint8)
    x = 0
    for p in panels:
        canvas[:p.shape[0], x:x + p.shape[1]] = p
        x += p.shape[1] + GAP
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    png.imwrite(out_path, canvas)
    return out_path


def render_run(seg_dir: str, out_dir: str, limit: int = 0) -> int:
    """Render every saved .npz segmentation map under ``seg_dir`` (the
    first ``limit`` in path order if ``limit``).  Output names join the
    relative path's parts with ``_`` (class directories etc.), so
    same-numbered samples of different classes don't overwrite each
    other."""
    root = Path(seg_dir)
    paths = sorted(root.rglob("*.npz"))
    if limit:
        paths = paths[:limit]
    for p in paths:
        name = "_".join(p.relative_to(root).with_suffix("").parts)
        with np.load(p) as z:
            render_heatmap(z["s_map"], str(Path(out_dir) / (name + ".png")),
                           gt=z.get("gt"))
    return len(paths)
