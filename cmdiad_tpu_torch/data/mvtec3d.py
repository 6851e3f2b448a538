"""MVTec 3D-AD dataset IO (host side), without Pillow.

The JAX package's ``data/mvtec3d.py`` on the port's own codecs: the
on-disk layout ``<root>/<class>/<split>/<defect>/{rgb,xyz,gt}/*``, with

  * RGB: PNG decode to RGB, Pillow's bicubic resize to ``rgb_size``,
    /255, ImageNet normalisation;
  * organized PC: TIFF -> (H, W, 3) float32, torch-style nearest resize to
    ``xyz_size``;
  * depth: the z channel replicated to 3 channels, the same nearest resize
    to ``rgb_size``;
  * GT: PNG decode to L, Pillow's NEAREST resize, /255, binarised at 0.5;
    ``good`` samples get an all-zero mask.

The arrays are bit-identical to the JAX package's.  Samples are numpy dicts
(channels-last) ready for upload; prefetch lives in ``data.loader``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from cmdiad_tpu_torch.data import png, tiffio
from cmdiad_tpu_torch.data.resize import (nearest_resize_np, pil_bicubic_resize_u8,
                                          pil_nearest_resize_u8)
from cmdiad_tpu_torch.ops.masked import host_compact_points

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def mvtec3d_classes() -> List[str]:
    return ["bagel", "cable_gland", "carrot", "cookie", "dowel",
            "foam", "peach", "potato", "rope", "tire"]


def eyecandies_classes() -> List[str]:
    return ["CandyCane", "ChocolateCookie", "ChocolatePraline", "Confetto",
            "GummyBear", "HazelnutTruffle", "LicoriceSandwich", "Lollipop",
            "Marshmallow", "PeppermintCandy"]


def load_rgb(path: str, size: int = 224) -> np.ndarray:
    """Bicubic resize + ImageNet normalise -> (size, size, 3) float32."""
    img = pil_bicubic_resize_u8(png.imread(path, "RGB"), size)
    arr = img.astype(np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def load_organized_pc(path: str, size: int = 224) -> np.ndarray:
    """TIFF organized pc -> nearest-resized (size, size, 3) float32."""
    pc = np.asarray(tiffio.imread(path), np.float32)
    if pc.ndim == 2:
        pc = np.repeat(pc[:, :, None], 3, axis=2)
    return np.ascontiguousarray(nearest_resize_np(pc, size))


def load_depth3(path_or_pc, size: int = 224) -> np.ndarray:
    """The z channel as a 3-channel depth image, nearest-resized."""
    pc = (np.asarray(tiffio.imread(path_or_pc), np.float32)
          if isinstance(path_or_pc, (str, Path)) else path_or_pc)
    d3 = np.repeat(pc[:, :, 2:3], 3, axis=2)
    return np.ascontiguousarray(nearest_resize_np(d3, size))


def load_gt(path: Optional[str], size: int = 224) -> np.ndarray:
    """(size, size) float32 binary mask; zeros when path is None ('good')."""
    if path is None:
        return np.zeros((size, size), np.float32)
    img = pil_nearest_resize_u8(png.imread(path, "L"), size)
    arr = img.astype(np.float32) / 255.0
    return (arr > 0.5).astype(np.float32)


@dataclasses.dataclass
class SampleRecord:
    rgb_path: str
    tiff_path: str
    gt_path: Optional[str]
    label: int


class MVTec3DDataset:
    """Path index over one class and split: ``train``, ``validation``,
    ``train_validation`` (train then validation) or ``test`` (every defect
    directory in sorted order; ``good`` has no gt)."""

    def __init__(self, root: str, class_name: str, split: str,
                 rgb_size: int = 224, xyz_size: int = 224, gt_size: int = 224,
                 point_capacity: int = 32768):
        self.root = Path(root)
        self.class_name = class_name
        self.split = split
        self.rgb_size, self.xyz_size, self.gt_size = rgb_size, xyz_size, gt_size
        # valid points are compacted on the loader threads when the grid
        # has more cells than this (ops.masked.host_compact_points); 0 = off
        self.point_capacity = (point_capacity
                               if point_capacity < xyz_size * xyz_size else 0)
        self.records = self._index()

    def _pairs(self, split_dir: Path, defect: str):
        rgb = sorted((split_dir / defect / "rgb").glob("*.png"))
        tif = sorted((split_dir / defect / "xyz").glob("*.tiff"))
        assert len(rgb) == len(tif), f"rgb/tiff mismatch in {split_dir / defect}"
        return rgb, tif

    def _index(self) -> List[SampleRecord]:
        records: List[SampleRecord] = []
        if self.split == "train_validation":
            dirs = [self.root / self.class_name / "train",
                    self.root / self.class_name / "validation"]
        else:
            dirs = [self.root / self.class_name / self.split]
        if self.split in ("train", "train_validation"):
            for d in dirs:
                rgb, tif = self._pairs(d, "good")
                records += [SampleRecord(str(r), str(t), None, 0)
                            for r, t in zip(rgb, tif)]
            return records
        test_dir = dirs[0]
        for defect in sorted(os.listdir(test_dir)):
            rgb, tif = self._pairs(test_dir, defect)
            if defect == "good":
                records += [SampleRecord(str(r), str(t), None, 0)
                            for r, t in zip(rgb, tif)]
            else:
                gts = sorted((test_dir / defect / "gt").glob("*.png"))
                assert len(gts) == len(rgb), "gt pairing broken"
                records += [SampleRecord(str(r), str(t), str(g), 1)
                            for r, t, g in zip(rgb, tif, gts)]
        return records

    def __len__(self) -> int:
        return len(self.records)

    def load(self, i: int) -> dict:
        rec = self.records[i]
        pc_raw = np.asarray(tiffio.imread(rec.tiff_path), np.float32)
        organized_pc = np.ascontiguousarray(nearest_resize_np(pc_raw, self.xyz_size))
        sample = {
            "rgb": load_rgb(rec.rgb_path, self.rgb_size),
            "organized_pc": organized_pc,
            "depth3": load_depth3(pc_raw, self.rgb_size),
            "label": rec.label,
            "rgb_path": rec.rgb_path,
        }
        if self.point_capacity:
            sample["points_compact"] = host_compact_points(
                organized_pc, self.point_capacity)
        if self.split == "test":
            sample["gt"] = load_gt(rec.gt_path, self.gt_size)
        return sample

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self.load(i)
