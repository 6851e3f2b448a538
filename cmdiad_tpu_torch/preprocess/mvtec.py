"""MVTec 3D-AD offline preprocessing, rewriting the dataset in place.

The JAX package's ``preprocess/mvtec.py`` (the reference's
utils/preprocessing.py:116-177): per tiff, RANSAC background-plane
removal, zero padding to a square whose side is the next multiple of 100,
and largest-DBSCAN-cluster cleaning, rewriting the tiff, the rgb png and
the gt png in place.  The plane fit and the cleaning run on ``device``;
the files are read and written with the port's own codecs
(``data/tiffio.py``, ``data/png.py``: rgb as RGB, gt as L).  A pool of
``num_workers`` threads reads and writes the files while one sample at a
time holds the device.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import logging
import math
import os
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from cmdiad_tpu_torch.data import png, tiffio
from cmdiad_tpu_torch.device import resolve_device
from cmdiad_tpu_torch.preprocess.cluster import largest_cluster_cleaning
from cmdiad_tpu_torch.preprocess.plane import remove_plane

log = logging.getLogger("cmdiad_tpu_torch")

TIMING_KEYS = ("io_s", "ransac_s", "dbscan_s")


def _roundup_100(x: int) -> int:
    return int(math.ceil(x / 100.0)) * 100


def pad_to_square(arr: torch.Tensor) -> torch.Tensor:
    """Zero-pad (H, W[, C]) to a square whose side is the larger dim
    rounded up to 100, the image centred (the extra row or column at the
    end)."""
    h, w = arr.shape[:2]
    side = max(_roundup_100(h), _roundup_100(w))
    a, b = (side - h) // 2, (side - w) // 2
    out = arr.new_zeros((side, side) + tuple(arr.shape[2:]))
    out[a:a + h, b:b + w] = arr
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def preprocess_sample(tiff_path: str, seed: int = 0, write: bool = True,
                      device="cuda", device_lock=None) -> dict:
    """Plane-remove + pad + cluster-clean one sample (in place if write).

    Returns the arrays (``pc``, ``rgb``, ``gt`` or None), ``n_clusters``
    and ``timings``: seconds reading and writing files (``io_s``), in the
    plane fit and removal (``ransac_s``, the upload included) and in the
    padding and cleaning (``dbscan_s``, the download included).
    ``device_lock`` is held around the device work."""
    dev = resolve_device(device)
    tiff_path = str(tiff_path)
    rgb_path = tiff_path.replace("xyz", "rgb").replace("tiff", "png")
    gt_path = tiff_path.replace("xyz", "gt").replace("tiff", "png")

    t0 = time.perf_counter()
    pc = np.array(tiffio.imread(tiff_path), np.float32)
    rgb = png.imread(rgb_path, "RGB")
    gt = png.imread(gt_path, "L") if os.path.isfile(gt_path) else None
    read_s = time.perf_counter() - t0
    with device_lock or contextlib.nullcontext():
        t1 = time.perf_counter()
        pc_t, rgb_t = remove_plane(torch.from_numpy(pc).to(dev),
                                   torch.from_numpy(rgb).to(dev), seed=seed)
        _sync(dev)
        t2 = time.perf_counter()
        pc_t, rgb_t, n_clusters = largest_cluster_cleaning(pad_to_square(pc_t),
                                                           pad_to_square(rgb_t))
        pc, rgb = pc_t.cpu().numpy(), rgb_t.cpu().numpy()
        t3 = time.perf_counter()
    if gt is not None:
        gt = pad_to_square(torch.from_numpy(gt)).numpy()
    if n_clusters > 1:
        log.info("%s has %d clusters (kept largest)", tiff_path, n_clusters)
    if write:
        tiffio.imwrite(tiff_path, pc)
        png.imwrite(rgb_path, rgb)
        if gt is not None:
            png.imwrite(gt_path, gt)
    t4 = time.perf_counter()
    timings = {"io_s": read_s + (t4 - t3), "ransac_s": t2 - t1, "dbscan_s": t3 - t2}
    return {"pc": pc, "rgb": rgb, "gt": gt, "n_clusters": n_clusters, "timings": timings}


def preprocess_dataset(dataset_path: str, num_workers: int = 6, seed: int = 0,
                       device="cuda") -> Tuple[int, Dict[str, float]]:
    """Preprocess every tiff under ``dataset_path`` in place.  Returns the
    number of tiffs and the per-phase seconds summed over them
    (``preprocess_sample``'s ``timings``) with the wall time ``wall_s``."""
    dev = resolve_device(device)
    paths = sorted(Path(dataset_path).rglob("*.tiff"))
    log.info("preprocessing %d tiffs under %s", len(paths), dataset_path)
    totals = dict.fromkeys(TIMING_KEYS, 0.0)
    lock = threading.Lock()
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = [pool.submit(preprocess_sample, str(p), seed, True, dev, lock)
                   for p in paths]
        for i, f in enumerate(cf.as_completed(futures)):
            for k, v in f.result()["timings"].items():
                totals[k] += v
            if (i + 1) % 100 == 0:
                log.info("processed %d/%d", i + 1, len(paths))
    totals["wall_s"] = time.perf_counter() - t0
    return len(paths), totals
