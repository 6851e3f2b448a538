"""Seeded test parts: a pool to score and the good parts banks come from.

A copy of the port's synthetic generator (``cmdiad_tpu_torch/data/
synthetic.py``: a smooth blob on a zeroed background, a dent pushed into
the surface and marked in the ground truth) and of its host compaction
(``ops/masked.host_compact_points``), sized by a traffic file: the side,
the valid-point range, the point capacity.  Every seed draws the same set
of valid-point counts and the same number of dented parts, in another
order, so that the seed changes which part comes when and not how much
work a pass holds.

The traffic's ``size`` is the cloud's side; the RGB image has a side of
its own, the configuration's ``rgb_size`` (by default the cloud's).  The
image is drawn at the cloud's side as uint8; where the two sides differ,
that uint8 image is resized to ``rgb_size`` by torch's antialiased
bicubic (``F.interpolate``, the a = -0.5 weights of PIL's BICUBIC, in one
float32 pass where PIL rounds between two), rounded and clipped back to
uint8, and only then normalised with ImageNet's mean and std, as M3DM
resizes a camera image to its ViT's side.  The resize draws nothing from the
generator, so every other array of a part is the same at either side, and
where the sides are equal the image is what it was without the key.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _valid_counts(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` evenly spaced targets inside [lo, hi], 2 % in from each end,
    so that the lattice count of a disc stays inside the range."""
    a, b = lo + 0.02 * (hi - lo), hi - 0.02 * (hi - lo)
    return a + (b - a) * (np.arange(n) + 0.5) / n


def blob(rng: np.random.Generator, size: int, n_valid: float, dent: bool,
         anomaly_radius=(0.05, 0.09)):
    """Organized cloud (size, size, 3) with a zero background holding about
    ``n_valid`` valid points, its gt mask and the object's footprint."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    r = float(np.sqrt(n_valid / np.pi) / size)
    lo, hi = max(0.4, r + 2.0 / size), min(0.6, 1.0 - r - 2.0 / size)
    cx, cy = rng.uniform(lo, hi, 2)
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    inside = d2 < r * r
    z = 0.4 + 0.2 * np.sqrt(np.maximum(r * r - d2, 0.0)) / r
    z += 0.01 * np.sin(xx * 20) * np.cos(yy * 17)
    z += rng.normal(0.0, 0.004, z.shape).astype(np.float32)
    gt = np.zeros((size, size), np.float32)
    if dent:
        ax = rng.uniform(cx - r / 2, cx + r / 2)
        ay = rng.uniform(cy - r / 2, cy + r / 2)
        ar = rng.uniform(*anomaly_radius)
        mask = ((xx - ax) ** 2 + (yy - ay) ** 2 < ar * ar) & inside
        z = np.where(mask, z - 0.15, z)
        gt[mask] = 1.0
    pc = np.stack([xx * 0.2, yy * 0.2, z], axis=-1).astype(np.float32)
    pc[~inside] = 0.0
    return pc, gt, inside


def resize_bicubic(img: np.ndarray, side: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (side, side, 3) uint8, antialiased bicubic."""
    x = torch.from_numpy(img).permute(2, 0, 1)[None].to(torch.float32)
    y = F.interpolate(x, size=(side, side), mode="bicubic", align_corners=False,
                      antialias=True)
    return y.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0).numpy()


def rgb_from_pc(rng: np.random.Generator, pc, inside, size: int,
                rgb_size: int) -> np.ndarray:
    """ImageNet-normalised (rgb_size, rgb_size, 3) float32 image of the
    blob, drawn at the cloud's side ``size``."""
    img = np.zeros((size, size, 3), np.float32)
    img[inside] = np.stack([pc[inside, 2]] * 3, -1) * 255 * 1.2
    img += rng.uniform(0, 20, img.shape)
    u8 = np.clip(img, 0, 255).astype(np.uint8)
    if rgb_size != size:
        u8 = resize_bicubic(u8, rgb_size)
    rgb = u8.astype(np.float32) / 255.0
    return (rgb - IMAGENET_MEAN) / IMAGENET_STD


def compact(pc: np.ndarray, capacity: int) -> np.ndarray:
    """The valid points of (H, W, 3) in scan order, zero-padded to
    (capacity, 3); more valid points than ``capacity`` is an error here
    (the traffic's range must fit)."""
    flat = pc.reshape(-1, 3)
    valid = flat[np.all(flat != 0.0, axis=1)]
    if len(valid) > capacity:
        raise ValueError(f"{len(valid)} valid points exceed the capacity {capacity}")
    out = np.zeros((capacity, 3), np.float32)
    out[: len(valid)] = valid
    return out


def make_parts(seed: int, n: int, traffic: dict, defect_share: float,
               tag: str, rgb_size: Optional[int] = None) -> List[Dict]:
    """``n`` parts from ``seed``: the sample dicts the port's loader gives
    (``rgb``, ``organized_pc``, ``points_compact``, ``gt``, ``label``,
    ``rgb_path``), ``round(n * defect_share)`` of them dented; the image at
    ``rgb_size`` (the traffic's ``size`` when None)."""
    rng = np.random.default_rng([seed, len(tag), sum(map(ord, tag))])
    size, cap = traffic["size"], traffic["point_capacity"]
    rgb_size = size if rgb_size is None else rgb_size
    lo, hi = traffic["valid_points"]
    counts = rng.permutation(_valid_counts(n, lo, hi))
    n_bad = int(round(n * defect_share))
    dents = rng.permutation(np.arange(n) < n_bad)
    parts = []
    for i in range(n):
        pc, gt, inside = blob(rng, size, counts[i], bool(dents[i]))
        parts.append({"rgb": rgb_from_pc(rng, pc, inside, size, rgb_size),
                      "organized_pc": pc,
                      "points_compact": compact(pc, cap),
                      "gt": gt,
                      "label": int(dents[i]),
                      "rgb_path": f"{tag}/{i:03d}.png"})
    return parts


def valid_points(part: Dict) -> int:
    return int(np.all(part["organized_pc"] != 0.0, axis=-1).sum())
