"""Synthetic MVTec-3D-style samples: in memory, or as an on-disk fixture.

Smooth random blobs on a zeroed background (like plane-removed organized
point clouds), with local depth dents (or, on disk, colour blotches on
normal geometry) and matching ground-truth masks as anomalies.

``make_synthetic_samples`` gives the dicts the data path hands the methods:
ImageNet-normalised ``rgb`` (H, W, 3), ``organized_pc`` (H, W, 3), ``gt``
(H, W), ``label``, ``rgb_path`` and, when the grid has more cells than the
point capacity, the host-compacted ``points_compact``.

``make_synthetic_dataset`` writes the MVTec 3D-AD layout
(``<class>/<split>/<defect>/{rgb,xyz,gt}``) through the port's PNG and TIFF
writers; from the same seed it writes the same pixel arrays as the JAX
package's fixture writer.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from cmdiad_tpu_torch.data import png, tiffio
from cmdiad_tpu_torch.data.mvtec3d import IMAGENET_MEAN, IMAGENET_STD
from cmdiad_tpu_torch.ops.masked import host_compact_points


def _blob_pc(rng, size: int, defect: str = "good",
             anomaly_radius=(0.05, 0.09)):
    """Organized pc (size, size, 3) with zero background, its gt mask and
    the object's footprint.  ``defect='dent'`` pushes a disc of radius
    ``anomaly_radius`` (in units of the side) into the surface;
    ``defect='blotch'`` leaves the geometry normal and only marks the disc
    in gt, for ``_rgb_from_pc`` to colour."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cx, cy = rng.uniform(0.4, 0.6, 2)
    r = rng.uniform(0.25, 0.35)
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    inside = d2 < r * r
    z = 0.4 + 0.2 * np.sqrt(np.maximum(r * r - d2, 0.0)) / r
    z += 0.01 * np.sin(xx * 20) * np.cos(yy * 17)
    z += rng.normal(0.0, 0.004, z.shape).astype(np.float32)
    gt = np.zeros((size, size), np.float32)
    if defect in ("dent", "blotch"):
        ax = rng.uniform(cx - r / 2, cx + r / 2)
        ay = rng.uniform(cy - r / 2, cy + r / 2)
        ar = rng.uniform(*anomaly_radius)
        mask = ((xx - ax) ** 2 + (yy - ay) ** 2 < ar * ar) & inside
        if defect == "dent":
            z = np.where(mask, z - 0.15, z)
        gt[mask] = 1.0
    pc = np.stack([xx * 0.2, yy * 0.2, z], axis=-1).astype(np.float32)
    pc[~inside] = 0.0
    return pc, gt, inside


def _rgb_from_pc(rng, pc, inside, size, blotch_mask=None):
    img = np.zeros((size, size, 3), np.float32)
    img[inside] = np.stack([pc[inside, 2]] * 3, -1) * 255 * 1.2
    if blotch_mask is not None:
        # a saturated colour defect on normal geometry
        img[blotch_mask > 0.5] = np.array([220.0, 30.0, 40.0])
    img += rng.uniform(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_synthetic_samples(n_train: int = 5, n_test_good: int = 3,
                           n_test_bad: int = 3, size: int = 64, seed: int = 0,
                           anomaly_radius=(0.05, 0.09),
                           point_capacity: int = 32768):
    """-> (train samples, test samples): ``n_train`` good samples, then
    ``n_test_good`` good and ``n_test_bad`` dented test samples."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for split, defect, n in (("train", "good", n_train),
                             ("test", "good", n_test_good),
                             ("test", "dent", n_test_bad)):
        for i in range(n):
            pc, gt, inside = _blob_pc(rng, size, defect, anomaly_radius)
            rgb = _rgb_from_pc(rng, pc, inside, size).astype(np.float32) / 255.0
            sample = {"rgb": (rgb - IMAGENET_MEAN) / IMAGENET_STD,
                      "organized_pc": pc,
                      "label": int(defect != "good"),
                      "rgb_path": f"synthetic/{split}/{defect}/{i:03d}.png"}
            if point_capacity < size * size:
                sample["points_compact"] = host_compact_points(pc, point_capacity)
            if split == "test":
                sample["gt"] = gt
                test.append(sample)
            else:
                train.append(sample)
    return train, test


def synthetic_files(class_names=("widget",), n_train: int = 6,
                    n_test_good: int = 2, n_test_bad: int = 3,
                    n_test_color: int = 0, size: int = 64, seed: int = 0,
                    anomaly_radius=(0.05, 0.09)) -> Iterator[Tuple[str, np.ndarray]]:
    """The fixture's files in writing order: (path relative to the root,
    array), the rgb as (size, size, 3) uint8, the organized pc as float32,
    the gt as (size, size) uint8 in {0, 255}.  Per class: ``n_train`` train
    samples, one validation sample, ``n_test_good`` good, ``n_test_bad``
    dented and ``n_test_color`` blotched test samples."""
    rng = np.random.default_rng(seed)
    for cls in class_names:
        for split, defect, n in (("train", "good", n_train),
                                 ("validation", "good", 1),
                                 ("test", "good", n_test_good),
                                 ("test", "dent", n_test_bad),
                                 ("test", "blotch", n_test_color)):
            for i in range(n):
                pc, gt, inside = _blob_pc(rng, size, defect, anomaly_radius)
                rgb = _rgb_from_pc(rng, pc, inside, size,
                                   blotch_mask=gt if defect == "blotch" else None)
                base, stem = f"{cls}/{split}/{defect}", f"{i:03d}"
                yield f"{base}/rgb/{stem}.png", rgb
                yield f"{base}/xyz/{stem}.tiff", pc
                if defect != "good":
                    yield f"{base}/gt/{stem}.png", (gt * 255).astype(np.uint8)


def make_synthetic_dataset(root: str, class_names=("widget",),
                           n_train: int = 6, n_test_good: int = 2,
                           n_test_bad: int = 3, n_test_color: int = 0,
                           size: int = 64, seed: int = 0,
                           anomaly_radius=(0.05, 0.09)) -> str:
    """Write a miniature MVTec-3D-layout dataset under ``root`` (the files
    of ``synthetic_files``, PNGs through ``data.png``, TIFFs through
    ``data.tiffio``); returns ``root``."""
    root_p = Path(root)
    for rel, arr in synthetic_files(class_names, n_train, n_test_good,
                                    n_test_bad, n_test_color, size, seed,
                                    anomaly_radius):
        path = root_p / rel
        os.makedirs(path.parent, exist_ok=True)
        if rel.endswith(".png"):
            png.imwrite(path, arr)
        else:
            tiffio.imwrite(str(path), arr)
    return str(root_p)
