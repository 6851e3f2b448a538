"""Per-class fit/evaluate orchestration (PyTorch port).

The reference's ``CMDIAD`` runner: two passes over the train split
(memory-bank building, then OCSVM late-fusion calibration) and a prediction
pass over the test split, with metric aggregation.  Samples come from the
MVTec 3D-AD tree at ``cfg.dataset_path`` through the threaded loader, or
from lists of in-memory sample dicts passed in
(``data.synthetic.make_synthetic_samples`` gives such lists).

With ``cfg.bank_cache_dir`` a class's fitted state is served from
``<dir>/<class>.npz`` when its config fingerprint matches, and a fresh fit
is persisted there; a mismatched or unreadable file is logged and refit.

``run_detection`` runs several classes on one backbone and one MTFI
fusion net, decoding the next class on a thread while the current one runs
on the card.

On a mesh (``cfg.mesh_shape``, ``cfg.shard_bank`` under a process group)
every rank runs the runner on its own device and reads the samples itself;
rank 0 writes the fitted-state cache (``save_state`` holds the others at a
barrier until the file is there), and a cache is served only where every
rank could load it, so all ranks fit or all serve.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.data.loader import iter_samples, stack_batches
from cmdiad_tpu_torch.data.mvtec3d import MVTec3DDataset
from cmdiad_tpu_torch.methods.base import StateFingerprintMismatch
from cmdiad_tpu_torch.methods.registry import build_backbone, build_fusion, build_method
from cmdiad_tpu_torch.parallel.mesh import all_agree

log = logging.getLogger("cmdiad_tpu_torch")


def _dataset(cfg: Config, split: str, class_name: str) -> MVTec3DDataset:
    return MVTec3DDataset(cfg.dataset_path, class_name, split,
                          rgb_size=cfg.rgb_size, xyz_size=cfg.xyz_size,
                          gt_size=cfg.gt_size)


def _train_split(cfg: Config) -> str:
    return "train_validation" if cfg.train_with_validation else "train"


class CMDIADRunner:
    def __init__(self, cfg: Config, backbone=None, device="cuda", fusion=None):
        self.cfg = cfg.validate()
        self.method = build_method(cfg, backbone=backbone, device=device, fusion=fusion)
        self.timings: Dict[str, float] = {}

    def _now(self) -> float:
        """Host clock after this rank's device has finished its queued
        work, so each phase's time holds its own device work."""
        if self.method.device.type == "cuda":
            torch.cuda.synchronize(self.method.device)
        return time.perf_counter()

    def _samples(self, split: str, class_name: str,
                 preloaded: Optional[List[dict]], max_samples=None):
        if preloaded is not None:
            return iter(preloaded if max_samples is None else preloaded[:max_samples])
        return iter_samples(_dataset(self.cfg, split, class_name),
                            max_samples=max_samples)

    def _bank_cache_path(self, class_name: str) -> Optional[str]:
        if not self.cfg.bank_cache_dir:
            return None
        os.makedirs(self.cfg.bank_cache_dir, exist_ok=True)
        return os.path.join(self.cfg.bank_cache_dir, f"{class_name}.npz")

    def _load_cached(self, class_name: str, cache: str) -> bool:
        """Serve the fitted state from ``cache``; False (logged) when it does
        not match the config or cannot be read, so the caller refits and
        overwrites it."""
        t0 = self._now()
        try:
            self.method.load_state(cache)
        except StateFingerprintMismatch as e:
            log.warning("class %s: %s", class_name, e)
            return False
        except Exception as e:  # noqa: BLE001 — truncated or corrupt file
            log.warning("class %s: unreadable fitted-state cache %s (%s: %s); "
                        "refitting", class_name, cache, type(e).__name__, e)
            return False
        self.timings["bank_load_s"] = self._now() - t0
        log.info("class %s: fitted state loaded from %s in %.2f s (fit skipped)",
                 class_name, cache, self.timings["bank_load_s"])
        return True

    def fit(self, class_name: str, train_samples: Optional[List[dict]] = None) -> None:
        """Bank pass + coreset + OCSVM-calibration pass over the first
        ``cfg.max_sample`` train samples (``train_samples``, or the
        dataset's train split when None), or the cached fitted state."""
        cache = self._bank_cache_path(class_name)
        if cache:
            served = os.path.exists(cache) and self._load_cached(class_name, cache)
            if self.method.mesh is not None:
                served = all_agree(served, self.method.mesh)
            if served:
                return
        split = _train_split(self.cfg)
        bs = max(self.cfg.batch_size, 1)
        t0 = self._now()
        n = 0
        for batch in stack_batches(self._samples(split, class_name, train_samples,
                                                 self.cfg.max_sample), bs):
            self.method.add_batch_to_mem_bank(batch, class_name=class_name)
            n += batch["_n"]
        t1 = self._now()
        self.method.run_coreset()
        t2 = self._now()
        for batch in stack_batches(self._samples(split, class_name, train_samples,
                                                 self.cfg.max_sample), bs):
            self.method.add_batch_to_late_fusion_mem_bank(batch)
        self.method.run_late_fusion()
        t3 = self._now()
        self.timings.update(bank_pass_s=t1 - t0, coreset_s=t2 - t1,
                            late_fusion_s=t3 - t2)
        log.info("class %s: fitted on %d samples %s", class_name, n, self.timings)
        if cache:
            self.method.save_state(cache)
            log.info("class %s: fitted state persisted to %s", class_name, cache)

    def evaluate(self, class_name: str,
                 test_samples: Optional[List[dict]] = None) -> Dict[str, float]:
        """Predict the test samples (``test_samples``, or the dataset's test
        split when None) and compute the metrics."""
        bs = max(self.cfg.batch_size, 1)
        t0 = self._now()
        n = 0
        for batch in stack_batches(self._samples("test", class_name, test_samples), bs):
            self.method.predict_batch(batch)
            n += batch["_n"]
        self.timings["eval_s"] = self._now() - t0
        self.timings["eval_images_per_s"] = n / max(self.timings["eval_s"], 1e-9)
        metrics = self.method.calculate_metrics()
        log.info("class %s: %s (%.2f img/s)", class_name, metrics,
                 self.timings["eval_images_per_s"])
        return metrics


def preload_class_samples(cfg: Config, class_name: str) -> Dict[str, List[dict]]:
    """Decode one class's train (capped at ``max_sample``) and test samples
    into host memory."""
    out = {}
    for key, split, cap in (("train", _train_split(cfg), cfg.max_sample),
                            ("test", "test", None)):
        out[key] = list(iter_samples(_dataset(cfg, split, class_name),
                                     max_samples=cap))
    return out


def run_detection(cfg: Config, classes: List[str], backbone=None, device="cuda",
                  on_class_done: Optional[Callable] = None) -> Dict[str, Dict[str, float]]:
    """fit + evaluate over ``classes`` on one backbone and one fusion net;
    returns {class: metrics}.

    The first class streams from disk; with ``cfg.preload_next_class`` each
    later class is decoded on a thread while the one before it runs.  A
    failed preload is raised once that thread has been joined.
    """
    cfg = cfg.validate()
    if backbone is None:
        backbone = build_backbone(cfg, device)
    fusion = build_fusion(cfg, backbone, backbone.device)
    results: Dict[str, Dict[str, float]] = {}
    box: Dict[str, Dict[str, List[dict]]] = {}
    errors: Dict[str, BaseException] = {}

    def _preload(cls: str):
        try:
            box[cls] = preload_class_samples(cfg, cls)
        except BaseException as e:  # noqa: BLE001 — raised after the join
            errors[cls] = e

    data: Optional[Dict[str, List[dict]]] = None
    for i, cls in enumerate(classes):
        pending = None
        if cfg.preload_next_class and i + 1 < len(classes):
            pending = threading.Thread(target=_preload, args=(classes[i + 1],),
                                       daemon=True)
            pending.start()
        try:
            runner = CMDIADRunner(cfg, backbone=backbone, device=backbone.device,
                                  fusion=fusion)
            runner.fit(cls, train_samples=data["train"] if data else None)
            results[cls] = runner.evaluate(cls, test_samples=data["test"] if data else None)
            if on_class_done:
                on_class_done(cls, results[cls], runner.timings)
        finally:
            if pending is not None:
                pending.join()
        data = None
        if pending is not None:
            nxt = classes[i + 1]
            if nxt in errors:
                raise RuntimeError(f"decoding class {nxt!r} failed") from errors.pop(nxt)
            data = box.pop(nxt)
    return results
