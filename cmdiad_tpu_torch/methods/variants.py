"""Method variants of the port: the four memory-bank methods.

  DINO            ``RGBMethod``     one rgb bank of ViT patches
  Point_MAE       ``PointMethod``   one xyz bank of Point-MAE patches
  Depth           ``DepthMethod``   ``RGBMethod`` on the 3-channel depth map
  DINO+Point_MAE  ``DoubleMethod``  both banks, Q1 cross-wired statistics

The MTFI methods are not ported yet; ``methods.registry.build_method``
refuses them.
"""

from __future__ import annotations

import torch

from cmdiad_tpu_torch.methods.base import MemoryBankMethod


class BatchedScoresMixin:
    """Batched bank and scoring passes for the plain methods.

    ``_batch_modalities`` lists (bank_name, feature_key, s_lambda,
    smap_lambda) per modality.  Tail padding from ``data.loader.
    stack_batches`` is sliced away with the batch's ``_n``.
    """

    def _batch_modalities(self):
        raise NotImplementedError

    def add_batch_to_mem_bank(self, batch: dict, class_name=None):
        self.class_name = class_name
        out = self.extract(batch)
        for bank_name, key, _, _ in self._batch_modalities():
            self._append(bank_name, out[key][:batch["_n"]])

    def _scores_batch(self, batch: dict):
        """-> (s_vec (B, k), maps (B, k, gt, gt)), λ-weighted, on the device."""
        out = self.extract(batch)
        ss, ms = [], []
        for bank_name, key, lam_s, lam_m in self._batch_modalities():
            s, m = self.score_patch_batch(out[key], bank_name)
            ss.append(lam_s * s.to(torch.float32))
            ms.append(lam_m * m.to(torch.float32))
        return torch.stack(ss, dim=1), torch.stack(ms, dim=1)

    def add_batch_to_late_fusion_mem_bank(self, batch: dict):
        s_vec, maps = self._scores_batch(batch)
        self.s_lib.append((s_vec, batch["_n"]))
        self.s_map_lib.append(maps)

    def predict_batch(self, batch: dict):
        s_vec, maps = self._scores_batch(batch)
        self._record_predictions(s_vec, maps, batch)


class RGBMethod(BatchedScoresMixin, MemoryBankMethod):
    """One rgb bank (reference ``RGBFeatures``)."""

    bank_names = ("rgb",)
    needed_keys = ("rgb",)   # never run the point backbone

    def _batch_modalities(self):
        c = self.cfg
        return [("rgb", "rgb_patch", c.rgb_s_lambda, c.rgb_smap_lambda)]

    def run_coreset(self):
        self._finalize_banks(norm_names=("rgb",), coreset_names=("rgb",))


class DepthMethod(RGBMethod):
    """The rgb pipeline on the 3-channel depth map (reference
    ``DepthFeatures``)."""

    needed_keys = ("depth3",)
    rgb_input_key = "depth3"


class PointMethod(BatchedScoresMixin, MemoryBankMethod):
    """One xyz bank (reference ``PointFeatures``)."""

    bank_names = ("xyz",)
    needed_keys = ("organized_pc", "points_compact")   # never run the ViT

    def _batch_modalities(self):
        c = self.cfg
        return [("xyz", "xyz_patch", c.xyz_s_lambda, c.xyz_smap_lambda)]

    def run_coreset(self):
        self._finalize_banks(norm_names=("xyz",), coreset_names=("xyz",))


class DoubleMethod(BatchedScoresMixin, MemoryBankMethod):
    """Dual rgb + xyz banks (reference ``DoubleRGBPointFeatures``)."""

    bank_names = ("xyz", "rgb")
    needed_keys = ("rgb", "organized_pc", "points_compact")

    def _batch_modalities(self):
        c = self.cfg
        return [("xyz", "xyz_patch", c.xyz_s_lambda, c.xyz_smap_lambda),
                ("rgb", "rgb_patch", c.rgb_s_lambda, c.rgb_smap_lambda)]

    def run_coreset(self):
        # Q1: both banks take their mean from the xyz bank and their std
        # from the rgb bank (reference multiple_features.py:877-880)
        self._finalize_banks(
            norm_names=("xyz", "rgb"), coreset_names=("xyz", "rgb"),
            stats_pairs={"xyz": ("xyz", "rgb"), "rgb": ("xyz", "rgb")})

    @staticmethod
    def _depth_swap(batch):
        """use_depth: the organized point cloud is fed as the rgb input at
        calibration and prediction time (never while banking)."""
        return {**batch, "rgb": batch["organized_pc"]}

    def add_batch_to_late_fusion_mem_bank(self, batch):
        if self.cfg.use_depth:
            batch = self._depth_swap(batch)
        BatchedScoresMixin.add_batch_to_late_fusion_mem_bank(self, batch)

    def predict_batch(self, batch):
        if self.cfg.use_depth:
            batch = self._depth_swap(batch)
        BatchedScoresMixin.predict_batch(self, batch)
