"""Method variants of the port: the six memory-bank methods.

  DINO            ``RGBMethod``     one rgb bank of ViT patches
  Point_MAE       ``PointMethod``   one xyz bank of Point-MAE patches
  Depth           ``DepthMethod``   ``RGBMethod`` on the 3-channel depth map
  DINO+Point_MAE  ``DoubleMethod``  both banks, Q1 cross-wired statistics;
                                    also the MTFI feature dumper
  WithHallucination
                  ``HallucinationMethod``  the main modality's bank and a
                                    bank of hallucinated features of the
                                    other: FtoF (``use_hn``, ``use_hn_conv``)
                                    on the main features, ItoF (``use_hrnet``)
                                    on the main raw input
  WithHallucinationFromFeature
                  ``HallucinationFromFeatureMethod``  FtoI: the other
                                    modality's raw input hallucinated from
                                    the main features and re-encoded

The MTFI methods read both modalities while fitting and only the main one
at inference (few-modal inference).  As in the JAX package the reference's
Q2 (the FtoI rgb-main prediction appended twice) is not replicated.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from cmdiad_tpu_torch.data.feature_store import FeatureStore
from cmdiad_tpu_torch.methods.base import MemoryBankMethod


class BatchedScoresMixin:
    """Batched bank and scoring passes for the plain methods.

    ``_batch_modalities`` lists (bank_name, feature_key, s_lambda,
    smap_lambda) per modality.  Tail padding from ``data.loader.
    stack_batches`` is sliced away with the batch's ``_n``.  Data-parallel,
    the features are this rank's block of the batch; the bank pass gathers
    them and scoring returns the whole batch's scores.
    """

    def _batch_modalities(self):
        raise NotImplementedError

    def add_batch_to_mem_bank(self, batch: dict, class_name=None):
        self.class_name = class_name
        out = self.extract(batch)
        for bank_name, key, _, _ in self._batch_modalities():
            self._append(bank_name, self.gather(out[key], batch["_n"]))

    def _scores_batch(self, batch: dict):
        """-> (s_vec (B, k), maps (B, k, gt, gt)), λ-weighted, on the device."""
        return self._weighted_scores(self.extract(batch))

    def _weighted_scores(self, out: dict):
        """Score each modality's features in ``out`` against its bank."""
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


def _sample_batches(batch: dict) -> Iterator[dict]:
    """The valid samples of a stacked batch, each as a batch of one."""
    for i in range(batch["_n"]):
        yield {**{k: v[i:i + 1] for k, v in batch.items() if k != "_n"}, "_n": 1}


class DoubleMethod(BatchedScoresMixin, MemoryBankMethod):
    """Dual rgb + xyz banks (reference ``DoubleRGBPointFeatures``).

    With ``save_feature_for_fusion``, ``save_frgb_xyz`` or ``save_rgb_fxyz``
    (and the matching ``save_path*``) every banked and every predicted
    sample is also written to its feature stores, in the JAX package's
    layout: ``<store>/{train,test}/<class><i>.npz``, one counter a store
    across both splits.  The bank and prediction passes then run one
    sample at a time, as the JAX package's do while stores are active; on
    a mesh every rank extracts the sample, as every JAX device does, and
    rank 0 writes it.
    """

    bank_names = ("xyz", "rgb")
    needed_keys = ("rgb", "organized_pc", "points_compact")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        c = self.cfg
        self._stores = {}
        for name, flag, path in (("fusion", c.save_feature_for_fusion, c.save_path),
                                 ("frgb_xyz", c.save_frgb_xyz, c.save_path_frgb_xyz),
                                 ("rgb_fxyz", c.save_rgb_fxyz, c.save_path_rgb_fxyz)):
            if flag and path:
                self._stores[name] = FeatureStore(path)
        self._dump_ids = {name: 0 for name in self._stores}

    def _maybe_dump(self, split: str, sample: dict, out: dict) -> None:
        """Write one sample (a batch of one) to the active stores; each
        feature crosses to the host once."""
        if not self.writes:
            return
        host = {}

        def feat(key):
            if key not in host:
                host[key] = out[key][0].cpu().numpy()
            return host[key]

        cls = self.class_name or "cls"
        for name, store in self._stores.items():
            fname = f"{cls}{self._dump_ids[name]}"
            if name == "fusion":
                store.save(split, fname, patch=np.concatenate(
                    [feat("xyz_patch"), feat("rgb_patch2")], axis=1))
            elif name == "frgb_xyz":
                store.save(split, fname, frgb=feat("rgb_patch2"),
                           xyz=np.asarray(sample["organized_pc"][0]))
            else:
                store.save(split, fname, hfxyz=feat("xyz_patch"),
                           lfxyz=feat("xyz_patch_2828"),
                           rgb=np.asarray(sample["rgb"][0]))
            self._dump_ids[name] += 1

    def add_batch_to_mem_bank(self, batch, class_name=None):
        if not self._stores:
            BatchedScoresMixin.add_batch_to_mem_bank(self, batch, class_name)
            return
        self.class_name = class_name
        for sample in _sample_batches(batch):
            out = self.extract(sample, with_2828=True)
            self._maybe_dump("train", sample, out)
            self._append("xyz", self.gather(out["xyz_patch"], 1))
            self._append("rgb", self.gather(out["rgb_patch"], 1))

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
        if not self._stores:
            BatchedScoresMixin.predict_batch(self, batch)
            return
        for sample in _sample_batches(batch):
            out = self.extract(sample, with_2828=True)
            self._maybe_dump("test", sample, out)
            self._record_predictions(*self._weighted_scores(out), sample)


class HallucinationMethod(BatchedScoresMixin, MemoryBankMethod):
    """Main-modality bank + hallucinated-feature bank, FtoF and ItoF
    (reference ``RGBorXYZWithOneHallucination``).

    The bank pass reads both modalities: the main bank and the fusion bank
    keep their rows, the other modality only streams the (sum, sum of
    squares, count) partials that the Q1 statistics read.  Inference reads
    the main modality's keys alone; for the xyz main the precompacted
    ``points_compact`` is forwarded with the organized cloud.
    """

    bank_names = ("rgb", "xyz", "fusion")
    needed_keys = ("rgb", "organized_pc", "points_compact")

    def _main_input_keys(self):
        return (("rgb",) if self.cfg.main_modality == "rgb"
                else ("organized_pc", "points_compact"))

    def _batch_modalities(self):
        """The main modality's bank, then the fusion bank."""
        c = self.cfg
        main = (("rgb", "rgb_patch", c.rgb_s_lambda, c.rgb_smap_lambda)
                if c.main_modality == "rgb"
                else ("xyz", "xyz_patch", c.xyz_s_lambda, c.xyz_smap_lambda))
        return [main, ("fusion", "fusion", c.fusion_s_lambda, c.fusion_smap_lambda)]

    def _stats_only_banks(self):
        return ("xyz",) if self.cfg.main_modality == "rgb" else ("rgb",)

    def _hallucinate(self, dev: dict, out: dict) -> torch.Tensor:
        """(B, N, D) hallucinated features of the other modality: HRNet on
        the main raw input, or the FtoF net on the main features."""
        c = self.cfg
        with torch.no_grad():
            if c.use_hrnet:
                img = dev["rgb"] if c.main_modality == "rgb" else dev["organized_pc"]
                grid = self.fusion(img)                     # (B, 56, 56, D)
                return grid.reshape(grid.shape[0], -1, grid.shape[-1])
            if c.main_modality == "rgb":
                return self.fusion.generate(out["rgb_patch2"], "xyz")
            return self.fusion.generate(out["xyz_patch"], "rgb")

    def _features(self, batch: dict, keys) -> dict:
        """Backbone features of ``keys`` and the hallucinated ``fusion``."""
        dev = self.upload(batch, keys)
        out = self.backbone.extract(images=dev.get("rgb"),
                                    organized_pc=dev.get("organized_pc"),
                                    compact_pts=dev.get("points_compact"))
        out["fusion"] = self._hallucinate(dev, out).to(torch.float32)
        return out

    def add_batch_to_mem_bank(self, batch, class_name=None):
        self.class_name = class_name
        n = batch["_n"]
        out = self._features(batch, self.needed_keys)
        for name, key in (("rgb", "rgb_patch"), ("xyz", "xyz_patch"),
                          ("fusion", "fusion")):
            self._append(name, self.gather(out[key], n))

    def _scores_batch(self, batch):
        return self._weighted_scores(self._features(batch, self._main_input_keys()))

    def run_coreset(self):
        main = self.cfg.main_modality
        # Q1 (reference multiple_features.py:372-377): every bank takes its
        # mean from the xyz bank and its std from the rgb bank
        self._finalize_banks(
            norm_names=(main, "fusion"), coreset_names=(main, "fusion"),
            stats_pairs={n: ("xyz", "rgb") for n in self.bank_names})


class HallucinationFromFeatureMethod(HallucinationMethod):
    """FtoI (reference ``RGBorXYZWithOneHallucinationFromFeature``): the
    fusion net turns the main features into the other modality's raw input,
    which the other backbone re-encodes; the only method where generated
    data re-enters a feature extractor.

    rgb main: ``rgb_patch2`` -> an organized point image, whose every point
    is fed as the compacted set (the regressed cloud is dense, so compaction
    to the loader's capacity would drop points) -> Point-MAE.  xyz main:
    ``xyz_patch`` -> an RGB image -> ViT.
    """

    def _hallucinate(self, dev, out):
        with torch.no_grad():
            if self.cfg.main_modality == "rgb":
                pc = self.fusion(out["rgb_patch2"]).to(torch.float32)
                return self.backbone.xyz_patches(
                    pc, compact_pts=pc.reshape(pc.shape[0], -1, 3))["xyz_patch"]
            img = self.fusion(out["xyz_patch"])
            return self.backbone.rgb_patches(img)[0]
