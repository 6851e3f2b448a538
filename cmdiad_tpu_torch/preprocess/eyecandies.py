"""Eyecandies -> MVTec-layout conversion, the projection on the card.

The JAX package's ``preprocess/eyecandies.py`` (the reference's
utils/preprocessing_eyecandies.py): a 16-bit depth png with its min/max
normalisation (``*_info_depth.yaml``) and the camera pose become an
organized point cloud by inverse camera projection, the background is
stripped after a rotation, and the samples are written as MVTec-style
``<class>/<split>/<defect>/{rgb,xyz,gt}`` trees.

The per-pixel math runs in float64 tensors on ``device`` and is cast to
float32 at the end, as the JAX package's numpy does; the depth is computed
in float32 first, as numpy computes it, and its reciprocal too.  Each
product of a small matrix with the pixels is written out as elementwise
sums, so the card and the CPU give the same bits; they differ from numpy's
BLAS products in float64 rounding only.  Without yaml, imageio or cv2 on
the card: the depth png is read by ``data.png.imread_grey16``, the yaml by
``read_depth_normalization``, and a mask is read as RGB and written back
as RGB, the pixels ``cv2.imread``/``cv2.imwrite`` leave in the file.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from shutil import copyfile
from typing import Tuple

import numpy as np
import torch

from cmdiad_tpu_torch.data import png, tiffio
from cmdiad_tpu_torch.device import resolve_device

log = logging.getLogger("cmdiad_tpu_torch")

FOCAL_LENGTH = 711.11

# YAML 1.1 decimal integers and floats, as PyYAML's resolver reads them
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_LINE = re.compile(r"( *)([^\s:#'\"{}\[\],&*!|>%@`-][^:#]*?):(?: +(.*?))? *$")


def _number(text: str, where: str) -> float:
    if _INT.match(text) or _FLOAT.match(text):
        return float(text.replace("_", ""))
    raise ValueError(f"{where}: {text!r} is not a decimal number")


def read_depth_normalization(path: str) -> Tuple[float, float]:
    """(min, max) of ``normalization`` in an ``*_info_depth.yaml``.

    Reads block mappings of plain scalars, the form ``yaml.safe_dump``
    writes (two levels here); raises ``ValueError`` on anything else
    (sequences, flow style, quoting, deeper nesting) and when the two keys
    are missing or not decimal numbers."""
    top, nested, current = {}, {}, None
    with open(path) as fh:
        for no, raw in enumerate(fh, 1):
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#") or line in ("---", "..."):
                continue
            m = _LINE.match(line)
            if m is None:
                raise ValueError(f"{path}:{no}: not a plain block mapping line: {line!r}")
            indent, key, value = len(m.group(1)), m.group(2), m.group(3)
            if value and value[0] in "'\"{}[]&*!|>%@`":
                raise ValueError(f"{path}:{no}: unsupported YAML value {value!r}")
            if indent == 0:
                current = key if not value else None
                top[key] = value
                if current is not None:
                    nested[current] = {}
            elif current is not None and value:
                nested[current][key] = value
            else:
                raise ValueError(f"{path}:{no}: unsupported YAML nesting: {line!r}")
    norm = nested.get("normalization", {})
    if "min" not in norm or "max" not in norm:
        raise ValueError(f"{path}: no normalization: {{min, max}} mapping")
    return (_number(norm["min"], f"{path}: normalization.min"),
            _number(norm["max"], f"{path}: normalization.max"))


def load_depth(depth_png: str, info_yaml: str, device="cuda") -> torch.Tensor:
    """Depth (H, W) float32: png / 65535 * (max - min) + min, each step
    rounded to float32 as numpy does."""
    mind, maxd = read_depth_normalization(info_yaml)
    device = resolve_device(device)
    d = torch.from_numpy(png.imread_grey16(depth_png).astype(np.float32)).to(device)
    # a tensor divisor: CUDA divides by a Python scalar as a multiplication
    # by its reciprocal, which is not numpy's correctly rounded quotient
    return d / d.new_tensor(65535.0) * float(np.float32(maxd - mind)) + float(np.float32(mind))


def _mat_vecs(m: np.ndarray, v) -> list:
    """Rows of the product of a small float64 matrix ``m`` (r, c) with the
    column vectors ``v`` (a list of c tensors), as elementwise sums."""
    out = []
    for row in m:
        acc = v[0] * float(row[0])
        for j in range(1, len(v)):
            acc = acc + v[j] * float(row[j])
        out.append(acc)
    return out


def depth_to_pointcloud(depth_png: str, info_yaml: str, pose_txt: str,
                        focal_length: float = FOCAL_LENGTH, device="cuda") -> torch.Tensor:
    """(H*W, 3) float64 point cloud from a depth image and a camera pose."""
    depth = load_depth(depth_png, info_yaml, device)
    pose = np.loadtxt(pose_txt)
    h, w = depth.shape[:2]
    intrinsics = np.array([[focal_length, 0, w / 2, 0],
                           [0, focal_length, h / 2, 0],
                           [0, 0, 1, 0],
                           [0, 0, 0, 1]])
    inv = np.linalg.inv(intrinsics @ pose)
    f64 = dict(dtype=torch.float64, device=depth.device)
    jj, ii = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    flat = depth.reshape(-1)
    vecs = [ii.reshape(-1), jj.reshape(-1), torch.ones(h * w, **f64),
            (torch.ones_like(flat) / flat).to(torch.float64)]
    hom = _mat_vecs(inv, vecs)
    d64 = flat.to(torch.float64)
    return torch.stack([d64 * hom[0], d64 * hom[1], d64 * hom[2]], dim=1)


def remove_background(pc: torch.Tensor) -> torch.Tensor:
    """Rotation-aligned background strip of a (H*W, 3) float64 cloud."""
    p0, p1 = pc[256].cpu().numpy(), pc[-256].cpu().numpy()
    dz, dy = p0[1] - p1[1], p0[2] - p1[2]
    norm = float(np.sqrt(dz ** 2 + dy ** 2))
    start = np.array([0.0, p1[1], p1[2]])
    cos_t, sin_t = dy / norm, dz / norm
    rot = np.array([[1, 0, 0], [0, cos_t, -sin_t], [0, sin_t, cos_t]])
    p = _mat_vecs(rot, [pc[:, i] - start[i] for i in range(3)])
    bg = (p[1] > -0.02) | (p[2] > 1.8) | (p[0] > 1) | (p[0] < -1)
    p = [torch.where(bg, torch.full_like(p[i], -start[i]), p[i]) for i in range(3)]
    p = [q + start[i] for i, q in enumerate(_mat_vecs(rot.T, p))]
    return torch.stack([p[0] * 0.1, p[2] * -0.1, p[1] * 0.1], dim=1)


def convert_sample(data_dir: Path, stem: str, out_xyz: Path, size: int = 512,
                   device="cuda") -> np.ndarray:
    """One sample's (size, size, 3) float32 cloud, written as a tiff."""
    pc = depth_to_pointcloud(str(data_dir / f"{stem}_depth.png"),
                             str(data_dir / f"{stem}_info_depth.yaml"),
                             str(data_dir / f"{stem}_pose.txt"), device=device)
    pc = remove_background(pc).reshape(size, size, 3).to(torch.float32).cpu().numpy()
    tiffio.imwrite(str(out_xyz), pc)
    return pc


def convert_dataset(dataset_path: str, target_dir: str, device="cuda") -> None:
    """The whole Eyecandies conversion (reference __main__ :92-187)."""
    dev = resolve_device(device)
    src, dst = Path(dataset_path), Path(target_dir)
    for category in sorted(os.listdir(src)):
        log.info("category %s", category)
        train_dir = src / category / "train" / "data"
        test_dir = src / category / "test_public" / "data"
        for split, defect in (("train", "good"), ("test", "good"), ("test", "bad")):
            for sub in ("rgb", "xyz") + (("gt",) if split == "test" else ()):
                os.makedirs(dst / category / split / defect / sub, exist_ok=True)

        for i in range(len(os.listdir(train_dir)) // 17):
            stem = str(i).zfill(3)
            out = dst / category / "train" / "good"
            convert_sample(train_dir, stem, out / "xyz" / f"{stem}.tiff", device=dev)
            copyfile(train_dir / f"{stem}_image_4.png", out / "rgb" / f"{stem}.png")

        for i in range(len(os.listdir(test_dir)) // 17):
            stem2, stem3 = str(i).zfill(2), str(i).zfill(3)
            mask = png.imread(test_dir / f"{stem2}_mask.png", "RGB")
            out = dst / category / "test" / ("bad" if mask.any() else "good")
            convert_sample(test_dir, stem2, out / "xyz" / f"{stem3}.tiff", device=dev)
            png.imwrite(out / "gt" / f"{stem3}.png", mask)
            copyfile(test_dir / f"{stem2}_image_4.png", out / "rgb" / f"{stem3}.png")
