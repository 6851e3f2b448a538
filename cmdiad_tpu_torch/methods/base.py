"""Shared memory-bank method machinery (PyTorch port).

The reference's ``Features`` base class: batched feature extraction, bank
accumulation on the device, (possibly cross-wired) normalisation
statistics, coreset selection, PatchCore scoring, the OCSVM late fusion
and the metrics.  Plain eager code: the same numbers as the JAX package's
fused programs, without their dispatch-saving structure.

Reference quirk Q1 (cross-wired normalisation statistics in the multi-bank
methods) is replicated unless ``fix_cross_stats=True``.  A bank that only
feeds those statistics (the MTFI methods' other modality) keeps no rows:
only (sum, sum of squares, count) partials, on the device.

Fitted state persists in the JAX package's npz layout with the same config
fingerprint, so state fitted by either package serves in the other.  With
``save_seg_results`` and ``save_raw_results`` the per-image fused maps and
the raw image scores are written in the JAX package's file layout.

Under a process group (``parallel.mesh``), as the JAX package does on a
mesh: ``mesh_shape=(n,)`` is data-parallel, each rank extracting and
scoring its block of every batch against a replica of the banks, the
scores gathered so that every rank fits the fusers on the same rows and
computes the same metrics; ``shard_bank`` keeps a block of each bank's rows
a rank (``parallel.eval``), the batch replicated.  Files are written by
rank 0.  ``shard_bank`` without a process group is one shard: the whole
bank, as on one JAX device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cmdiad_tpu_torch import tracing
from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.fusion.ocsvm import SGDOneClassSVM
from cmdiad_tpu_torch.metrics import calculate_au_pro, roc_auc_score
from cmdiad_tpu_torch.ops.bank_min import quantize_rows
from cmdiad_tpu_torch.ops.coreset import coreset_select
from cmdiad_tpu_torch.ops.scoring import bank_nn_table, pad_bank, patchcore_score
from cmdiad_tpu_torch.parallel.eval import dp_score_batch, sharded_score_batch
from cmdiad_tpu_torch.parallel.mesh import (Mesh, barrier, gather_rows, make_mesh,
                                            shard_batch, shard_rows)


class StateFingerprintMismatch(ValueError):
    """Persisted fitted state was produced under a different scoring-relevant
    configuration (or format) than the current run."""


# Bump whenever the persisted layout or serving semantics change; shared
# with the JAX package (cmdiad_tpu/methods/base.py), whose state files the
# port reads.
_STATE_FORMAT_VERSION = 2

# Every config field that shapes the fitted state or how it is scored —
# the JAX package's list, so fingerprints agree across the two packages.
_FINGERPRINT_FIELDS = (
    "method_name", "main_modality",
    "use_hn", "use_hn_conv", "use_hn_from_rgb_mlp", "use_hn_from_rgb_conv",
    "use_hrnet", "c_hrnet", "fusion_module_path", "use_depth",
    "rgb_backbone_name", "xyz_backbone_name", "group_size", "num_group",
    "rgb_ckpt_path", "xyz_ckpt_path",
    "dataset_type", "dataset_path",
    "rgb_size", "xyz_size", "gt_size", "max_sample", "train_with_validation",
    "f_coreset", "coreset_eps", "coreset_dtype",
    "dist_method_s", "dist_method_coreset", "random_state", "n_reweight",
    "quantized_blur",
    "xyz_s_lambda", "xyz_smap_lambda", "rgb_s_lambda", "rgb_smap_lambda",
    "fusion_s_lambda", "fusion_smap_lambda",
    "ocsvm_nu", "ocsvm_maxiter", "ocsvm_backend", "ocsvm_seg_max_rows",
    "compute_dtype", "use_pallas", "use_flash", "seed",
)

_SAMPLE_KEYS = ("rgb", "organized_pc", "depth3", "points_compact")


def method_mesh(cfg: Config, device) -> Optional[Mesh]:
    """The mesh a method runs on: ``cfg.mesh_shape`` over the process group
    (raises without one), else every rank of an initialised group when
    ``cfg.shard_bank`` asks for shards, else none (one device)."""
    if cfg.mesh_shape:
        return make_mesh(cfg.mesh_shape, device)
    if cfg.shard_bank and dist.is_available() and dist.is_initialized():
        return make_mesh((dist.get_world_size(),), device)
    return None


class MemoryBankMethod:
    """Base: bank accumulation, coreset, scoring, late fusion, metrics."""

    #: bank names this method maintains (subclasses set)
    bank_names: Tuple[str, ...] = ()
    #: sample keys ``extract`` uploads and feeds the backbone (subclasses
    #: set); single-modality methods list theirs, so they never run the
    #: other backbone
    needed_keys: Tuple[str, ...] = ()
    #: the sample key the ViT reads
    rgb_input_key = "rgb"

    def __init__(self, cfg: Config, backbone, fusion=None,
                 fix_cross_stats: bool = False):
        self.cfg = cfg
        self.backbone = backbone
        self.device = backbone.device
        # the MTFI fusion net (models.hallucination / models.hrnet), or None
        self.fusion = fusion
        self.fix_cross_stats = fix_cross_stats
        self.class_name: Optional[str] = None
        self.mesh = method_mesh(cfg, self.device)
        # shard_bank takes precedence over data-parallel batches, and
        # cos_dist scores a whole bank, as in the JAX package
        self.dp_mesh = self.mesh if not cfg.shard_bank else None
        self.bank_mesh = (self.mesh if cfg.shard_bank and cfg.dist_method_s != "cos_dist"
                          else None)
        #: whether this process writes files (rank 0, or the only process)
        self.writes = self.mesh is None or self.mesh.rank == 0

        self._bank_acc: Dict[str, List[torch.Tensor]] = {n: [] for n in self.bank_names}
        # stats-only banks: (sum, sum of squares, count) partials a batch
        self._stats_acc: Dict[str, List[Tuple[torch.Tensor, torch.Tensor, int]]] = {}
        self.banks: Dict[str, torch.Tensor] = {}
        self.bank_sizes: Dict[str, int] = {}     # true rows before pad_bank
        self.nn_tables: Dict[str, torch.Tensor] = {}
        self.coreset_idx: Dict[str, torch.Tensor] = {}
        self.stats: Dict[str, Tuple[float, float]] = {}
        # per bank: the bank-min kernel's operands (see
        # _bank_kernel_operands), made once per fitted or loaded bank
        self._bank_aux: Dict[str, Dict[str, torch.Tensor]] = {}

        self.detect_fuser, self.seg_fuser = (
            SGDOneClassSVM(nu=cfg.ocsvm_nu, max_iter=cfg.ocsvm_maxiter, random_state=42,
                           backend=cfg.ocsvm_backend, device=self.device)
            for _ in range(2))
        self.s_lib: List[Tuple[torch.Tensor, int]] = []   # ((B, k), n valid)
        self.s_map_lib: List[torch.Tensor] = []           # (B, k, gt, gt)
        self.reset_predictions()
        self.image_rocauc = self.pixel_rocauc = 0.0
        self.au_pro = self.au_pro_001 = 0.0

    # ---------------- features --------------------------------------------
    @tracing.span("upload")
    def upload(self, batch: dict, keys=None) -> Dict[str, torch.Tensor]:
        """The sample arrays of a stacked batch under ``keys`` (default
        ``needed_keys``) on the device; data-parallel, this rank's block of
        them (``parallel.mesh.shard_batch``).  The copies do not block the
        host (``tracing.stage``), and the image goes first, so that its
        copy runs while the host stages the clouds."""
        keys = self.needed_keys if keys is None else keys
        out = {}
        for k in _SAMPLE_KEYS:
            if k in batch and k in keys:
                arr = np.asarray(batch[k])
                if self.dp_mesh is not None:
                    arr = shard_batch(arr, self.dp_mesh)[0]
                out[k] = tracing.stage(arr, self.device)
        return out

    def gather(self, rows: torch.Tensor, n: int) -> torch.Tensor:
        """The first ``n`` rows of a batch whose rows ``rows`` holds: under
        data parallelism this rank's block, gathered in batch order."""
        if self.dp_mesh is not None:
            rows = gather_rows(rows, self.dp_mesh)
        return rows[:n]

    def extract(self, batch: dict, with_2828: bool = False) -> dict:
        """Backbone features of a stacked batch (numpy arrays -> device),
        from the keys in ``needed_keys`` only; data-parallel, of this
        rank's block."""
        dev = self.upload(batch)
        return self.backbone.extract(images=dev.get(self.rgb_input_key),
                                     organized_pc=dev.get("organized_pc"),
                                     compact_pts=dev.get("points_compact"),
                                     with_2828=with_2828)

    def _stats_only_banks(self) -> Tuple[str, ...]:
        """Banks that are never scored: only their scalar mean and std feed
        the (cross-wired) statistics, so no rows are kept."""
        return ()

    def _append(self, name: str, patch: torch.Tensor) -> None:
        rows = patch.to(torch.float32).reshape(-1, patch.shape[-1])
        if name in self._stats_only_banks():
            self._stats_acc.setdefault(name, []).append(
                (rows.sum(), (rows * rows).sum(), rows.numel()))
        else:
            self._bank_acc[name].append(rows)

    def _streamed_stats(self, name: str) -> Tuple[float, float]:
        """(mean, std with ddof=1) of a stats-only bank from its partials,
        combined in float64 on the host."""
        parts = self._stats_acc.get(name)
        if not parts:
            raise ValueError(f"bank {name!r} has no accumulated rows or streamed stats")
        s1 = sum(float(p[0]) for p in parts)
        s2 = sum(float(p[1]) for p in parts)
        cnt = sum(p[2] for p in parts)
        mean = s1 / max(cnt, 1)
        var = max(s2 - cnt * mean * mean, 0.0) / max(cnt - 1, 1)
        return mean, float(np.sqrt(var))

    # ---------------- bank building ---------------------------------------
    def _finalize_banks(self, norm_names, coreset_names,
                        stats_pairs: Optional[Dict[str, Tuple[str, str]]] = None):
        """Concatenate the accumulated rows, compute the (possibly
        cross-wired) statistics, normalise, coreset-select, pad and build
        the NN tables of every bank that kept rows.

        stats_pairs maps bank -> (mean source, std source); the reference's
        Q1 wiring is e.g. {'rgb': ('xyz', 'rgb')}.
        """
        stats_only = self._stats_only_banks()
        cat, cat_stats = {}, {}
        for n in self.bank_names:
            if n in stats_only:
                cat_stats[n] = self._streamed_stats(n)
                continue
            cat[n] = torch.cat(self._bank_acc[n])
            self._bank_acc[n] = []
            cat_stats[n] = (float(cat[n].mean()), float(cat[n].std()))
        self._stats_acc = {}
        if self.fix_cross_stats or stats_pairs is None:
            stats_pairs = {n: (n, n) for n in self.bank_names}
        for n in self.bank_names:
            msrc, ssrc = stats_pairs[n]
            self.stats[n] = (cat_stats[msrc][0], cat_stats[ssrc][1])
        for n in list(cat):
            bank = cat.pop(n)
            if n in norm_names:
                mean, std = self.stats[n]
                bank = (bank - mean) / std
            if n in coreset_names and self.cfg.f_coreset < 1:
                idx = coreset_select(
                    bank, self.cfg.f_coreset, eps=self.cfg.coreset_eps,
                    seed=self.cfg.random_state or 0,
                    metric=self.cfg.dist_method_coreset,
                    compute_dtype=self.cfg.coreset_dtype)
                self.coreset_idx[n] = idx
                bank = bank[idx]
            self.bank_sizes[n] = int(bank.shape[0])
            padded = pad_bank(bank.to(torch.float32))
            self.nn_tables[n] = bank_nn_table(
                padded, k=self.cfg.n_reweight,
                n_valid=self.bank_sizes[n], metric=self.cfg.dist_method_s)
            self.banks[n] = self._place_bank(padded)
        self._bank_aux = {}

    def _place_bank(self, bank: torch.Tensor) -> torch.Tensor:
        """This rank's block of a padded bank's rows under ``shard_bank``,
        else the whole bank (a replica on each rank)."""
        return bank if self.bank_mesh is None else shard_rows(bank, self.bank_mesh)

    def _whole_bank(self, name: str) -> torch.Tensor:
        """Bank ``name`` with every rank's rows (a collective when sharded)."""
        bank = self.banks[name]
        return bank if self.bank_mesh is None else gather_rows(bank, self.bank_mesh)

    # ---------------- scoring ---------------------------------------------
    def _bank_kernel_operands(self, name: str) -> Dict[str, torch.Tensor]:
        """The bank-min kernel's operands of bank ``name``: exact squared
        row norms plus the bfloat16 rows (``l2``) or the int8 rows and row
        scales (``l2_int8``); empty for the exact metrics."""
        metric = self.cfg.dist_method_s
        if metric not in ("l2", "l2_int8"):
            return {}
        if name not in self._bank_aux:
            bank = self.banks[name]
            ops = {"bnorm": torch.sum(bank * bank, dim=1).contiguous()}
            if metric == "l2":
                ops["bank_bf16"] = bank.to(torch.bfloat16).contiguous()
            else:
                ops["bank_s8"], ops["bscale"] = quantize_rows(bank)
            self._bank_aux[name] = ops
        return self._bank_aux[name]

    def score_patch_batch(self, patches: torch.Tensor, bank_name: str):
        """patches (B, Np, D) -> (s (B,), s_map (B, gt, gt))."""
        side = int(np.sqrt(patches.shape[1]))
        mean, std = self.stats[bank_name]
        normed, bank = (patches - mean) / std, self.banks[bank_name]
        kw = dict(out_size=self.cfg.gt_size, metric=self.cfg.dist_method_s,
                  n_reweight=self.cfg.n_reweight, n_valid=self.bank_sizes[bank_name],
                  nn_table=self.nn_tables[bank_name],
                  bank_operands=self._bank_kernel_operands(bank_name),
                  quantized_blur=self.cfg.quantized_blur)
        if self.bank_mesh is not None:
            return sharded_score_batch(self.bank_mesh, normed, bank, (side, side), **kw)
        if self.dp_mesh is not None:
            # patches are this rank's block: every rank gets the whole batch
            return dp_score_batch(self.dp_mesh, normed, bank, (side, side), **kw)
        return patchcore_score(normed, bank, (side, side), **kw)

    # ---------------- late fusion ------------------------------------------
    def run_late_fusion(self):
        """Fit the two OCSVM fusers on the calibration pass's rows.  The
        seg fuser sees every ``stride``-th pixel row of each calibration
        batch, the stride chosen so at most ``cfg.ocsvm_seg_max_rows`` rows
        remain in total (None: every row)."""
        cap = self.cfg.ocsvm_seg_max_rows
        total = sum(n * mp.shape[2] * mp.shape[3]
                    for (_, n), mp in zip(self.s_lib, self.s_map_lib))
        stride = max(1, -(-total // cap)) if cap else 1
        s_rows, m_rows = [], []
        for (sv, n), mp in zip(self.s_lib, self.s_map_lib):
            s_rows.append(sv[:n].double().cpu().numpy())
            rows = mp[:n].permute(0, 2, 3, 1).reshape(-1, mp.shape[1])
            m_rows.append(rows[::stride].double().cpu().numpy())
        self.detect_fuser.fit(np.concatenate(s_rows, axis=0))
        self.seg_fuser.fit(np.concatenate(m_rows, axis=0))
        self.s_lib, self.s_map_lib = [], []
        self._fuser_weights()                       # on the device now, not in a call

    def _fuser_weights(self):
        """The two fusers' float32 weight vectors on the device, uploaded
        once a fit or load (``SGDOneClassSVM.device_coef``)."""
        return self.detect_fuser.device_coef(), self.seg_fuser.device_coef()

    def _record_predictions(self, s_vec, maps, batch):
        """Fuse λ-weighted (B, k) scores and (B, k, gt, gt) maps through the
        linear fusers (score_samples = x·coef) and store the valid rows.
        The scores and maps come back in one copy, the call's one host wait."""
        wd, ws = self._fuser_weights()
        s = s_vec.to(torch.float32) @ wd
        fused = torch.einsum("bkxy,k->bxy", maps.to(torch.float32), ws)
        host = tracing.to_host(torch.cat([s[:, None], fused.flatten(1)], dim=1)).numpy()
        s, fused = host[:, 0], host[:, 1:].reshape(fused.shape)
        for i in range(batch["_n"]):
            self._store_prediction(float(s[i]), fused[i].astype(np.float64),
                                   batch["gt"][i], batch["label"][i],
                                   batch["rgb_path"][i])

    def _store_prediction(self, s, fused_map, mask, label, rgb_path):
        gt = self.cfg.gt_size
        fused_map = np.asarray(fused_map).reshape(gt, gt)
        mask_np = np.asarray(mask).reshape(gt, gt)
        self.image_preds.append(s)
        self.image_labels.append(int(label))
        self.pixel_preds.append(fused_map.reshape(-1))
        self.pixel_labels.append(mask_np.reshape(-1))
        self.predictions.append(fused_map)
        self.gts.append(mask_np)
        self.img_paths.append(rgb_path)
        if self.cfg.save_seg_results and self.writes:
            # results/segmentation/<class>/<rgb file stem>.npz, as the JAX
            # package writes it: the stem alone, so the same file name in
            # two defect directories lands on one file and the last wins
            stem = os.path.splitext(os.path.basename(str(rgb_path)))[0]
            out_dir = os.path.join(self.cfg.results_dir, "segmentation",
                                   str(self.class_name))
            os.makedirs(out_dir, exist_ok=True)
            np.savez_compressed(os.path.join(out_dir, stem + ".npz"),
                                s_map=fused_map, gt=mask_np)

    def reset_predictions(self):
        """Clear accumulated predictions (e.g. to run an eval pass again)."""
        self.image_preds, self.image_labels = [], []
        self.pixel_preds, self.pixel_labels = [], []
        self.predictions, self.gts, self.img_paths = [], [], []

    # ---------------- fitted-state persistence ------------------------------
    def state_fingerprint(self) -> dict:
        fp = {f: getattr(self.cfg, f) for f in _FINGERPRINT_FIELDS}
        fp["_format"] = _STATE_FORMAT_VERSION
        return fp

    def save_state(self, path: str) -> None:
        """Persist padded banks, NN tables, true row counts, Q1 stats and the
        two linear fusers in the JAX package's npz layout (atomic rename).
        On a mesh every rank calls it (a sharded bank is gathered), rank 0
        writes and the others wait for the file."""
        banks = {n: self._whole_bank(n) for n in self.banks}
        if self.writes:
            self._write_state(path, banks)
        barrier(self.mesh)

    def _write_state(self, path: str, banks: Dict[str, torch.Tensor]) -> None:
        arrs = {}
        for n in self.banks:
            arrs[f"bank_{n}"] = banks[n].cpu().numpy()
            arrs[f"nn_{n}"] = self.nn_tables[n].to(torch.int32).cpu().numpy()
        for tag, f in (("detect", self.detect_fuser), ("seg", self.seg_fuser)):
            arrs[f"{tag}_coef"] = np.asarray(f.coef_, np.float64).reshape(-1)
            arrs[f"{tag}_offset"] = np.asarray(f.offset_, np.float64).reshape(-1)
        meta = {"bank_sizes": self.bank_sizes,
                "stats": {k: list(v) for k, v in self.stats.items()},
                "class_name": self.class_name,
                "fingerprint": self.state_fingerprint()}
        arrs["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **arrs)
        os.replace(tmp, path)

    def load_state(self, path: str) -> None:
        """Restore ``save_state`` output (written by either package), each
        bank sharded again under ``shard_bank``.  Raises
        StateFingerprintMismatch when the persisted fingerprint differs from
        the current config."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            saved_fp = meta.get("fingerprint")
            fp = self.state_fingerprint()
            if saved_fp != fp:
                diff = sorted(k for k in fp if not isinstance(saved_fp, dict)
                              or saved_fp.get(k) != fp[k])
                raise StateFingerprintMismatch(
                    f"{path}: persisted state does not match the current config "
                    f"(differing fields: {diff}); refit required")
            self.class_name = meta["class_name"]
            self.bank_sizes = {k: int(v) for k, v in meta["bank_sizes"].items()}
            self.stats = {k: (float(v[0]), float(v[1]))
                          for k, v in meta["stats"].items()}
            self.banks, self.nn_tables = {}, {}
            for key in z.files:
                if key.startswith("bank_"):
                    n = key[len("bank_"):]
                    self.banks[n] = self._place_bank(
                        torch.as_tensor(z[key], device=self.device))
                    self.nn_tables[n] = torch.as_tensor(
                        z[f"nn_{n}"], device=self.device).to(torch.int64)
            self.detect_fuser.load_weights(z["detect_coef"], z["detect_offset"])
            self.seg_fuser.load_weights(z["seg_coef"], z["seg_offset"])
        self._bank_aux = {}
        self._fuser_weights()                       # on the device now, not in a call

    # ---------------- metrics ----------------------------------------------
    def calculate_metrics(self) -> dict:
        image_preds = np.asarray(self.image_preds)
        image_labels = np.asarray(self.image_labels)
        if self.cfg.save_raw_results and self.writes:
            # results/raw/<class>_raw_results.csv: score,label,path a line
            out_dir = os.path.join(self.cfg.results_dir, "raw")
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{self.class_name}_raw_results.csv"),
                      "w") as fh:
                for s, lab, path in zip(image_preds, image_labels, self.img_paths):
                    fh.write(f"{s},{lab},{path}\n")
        pixel_preds = np.concatenate(self.pixel_preds)
        pixel_labels = np.concatenate(self.pixel_labels)
        self.image_rocauc = roc_auc_score(image_labels, image_preds)
        self.pixel_rocauc = roc_auc_score(pixel_labels, pixel_preds)
        self.au_pro, _ = calculate_au_pro(self.gts, self.predictions)
        self.au_pro_001, _ = calculate_au_pro(self.gts, self.predictions, 0.01)
        return {"image_rocauc": self.image_rocauc,
                "pixel_rocauc": self.pixel_rocauc,
                "au_pro": self.au_pro,
                "au_pro_001": self.au_pro_001}
