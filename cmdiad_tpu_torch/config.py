"""Typed configuration for detection runs (PyTorch port).

A copy of ``cmdiad_tpu.config.Config``: the same fields, defaults and
``validate``, so a config fingerprint written by either package reads the
same in the other (``methods.base.state_fingerprint``).  Fields that only
shape the JAX package's TPU execution (meshes, fused programs, Pallas
switches) are kept for that reason.  Of those, the port refuses what it
cannot honour yet (``mesh_shape``, ``shard_bank``, ``ocsvm_backend='jax'``
raise ``NotImplementedError`` through ``methods.base.refuse_unported`` when
a method is built) and ignores the ones that shape only the JAX package's
speed (``use_pallas``, ``fused_eval``, ``cache_train_features``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


METHOD_NAMES = (
    "DINO",                # RGB-only memory bank
    "Point_MAE",           # point-cloud-only memory bank
    "DINO+Point_MAE",      # dual bank, also the feature dumper for MTFI
    "Depth",               # depth-map bank
    "WithHallucination",           # MTFI FtoF (MLP/conv) or ItoF (HRNet)
    "WithHallucinationFromFeature",  # MTFI FtoI: hallucinate the input, re-encode
)


@dataclass(frozen=True)
class Config:
    """Detection/eval configuration (reference ``main.py`` parser equivalent)."""

    # --- method selection -------------------------------------------------
    method_name: str = "DINO+Point_MAE"
    main_modality: str = ""
    use_hn: bool = False
    use_hn_conv: bool = False
    use_hn_from_rgb_mlp: bool = False
    use_hn_from_rgb_conv: bool = False
    use_hrnet: bool = False
    c_hrnet: int = 512
    fusion_module_path: str = ""
    use_depth: bool = False

    # --- backbones ---------------------------------------------------------
    rgb_backbone_name: str = "vit_base_patch8_224_dino"
    xyz_backbone_name: str = "Point_MAE"
    group_size: int = 128   # KNN group size M
    num_group: int = 1024   # FPS centers G
    rgb_ckpt_path: str = ""
    xyz_ckpt_path: str = ""

    # --- dataset -----------------------------------------------------------
    dataset_type: str = "mvtec3d"
    dataset_path: str = "datasets/mvtec_3d"
    class_name: Optional[str] = None
    rgb_size: int = 224
    xyz_size: int = 224
    gt_size: int = 224
    max_sample: int = 500
    train_with_validation: bool = False
    preload_next_class: bool = True

    # --- memory bank / scoring ---------------------------------------------
    cache_train_features: bool = False
    f_coreset: float = 0.1
    coreset_eps: float = 0.9
    coreset_dtype: str = "FP16"  # 'FP16' (= bfloat16) | 'TF32' | 'FP32'
    # 'l2' | 'l1' | 'cos_dist' | 'l2_int8'
    dist_method_s: str = "l2"
    dist_method_coreset: str = "l2"
    random_state: Optional[int] = None
    n_reweight: int = 3
    quantized_blur: bool = False

    # --- score fusion lambdas ----------------------------------------------
    xyz_s_lambda: float = 1.0
    xyz_smap_lambda: float = 1.0
    rgb_s_lambda: float = 0.1
    rgb_smap_lambda: float = 0.1
    fusion_s_lambda: float = 1.0
    fusion_smap_lambda: float = 1.0

    # --- OCSVM late fusion ---------------------------------------------------
    ocsvm_nu: float = 0.5
    ocsvm_maxiter: int = 1000
    ocsvm_backend: str = "sklearn"
    # cap on the pixel rows the SEG fuser is fit on (a deterministic stride
    # per calibration batch); None = fit on every row
    ocsvm_seg_max_rows: Optional[int] = 2_000_000

    # --- feature dumping for MTFI distillation training ----------------------
    save_feature_for_fusion: bool = False
    save_frgb_xyz: bool = False
    save_rgb_fxyz: bool = False
    save_path: str = ""
    save_path_frgb_xyz: str = ""
    save_path_rgb_fxyz: str = ""

    # --- outputs --------------------------------------------------------------
    save_results: bool = True
    results_dir: str = "results"
    bank_cache_dir: str = ""
    save_raw_results: bool = False
    save_seg_results: bool = False
    experiment_note: str = ""

    # --- execution -----------------------------------------------------------
    compute_dtype: str = "float32"
    batch_size: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    mesh_shape: Tuple[int, ...] = ()
    shard_bank: bool = False
    use_pallas: bool = True
    fused_eval: bool = True
    use_flash: bool = False
    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "Config":
        if self.method_name not in METHOD_NAMES:
            raise ValueError(f"unknown method {self.method_name!r}; choose from {METHOD_NAMES}")
        n_fusion_flags = sum(
            [self.use_hn, self.use_hn_conv, self.use_hn_from_rgb_mlp,
             self.use_hn_from_rgb_conv, self.use_hrnet])
        if self.method_name in ("WithHallucination", "WithHallucinationFromFeature"):
            if self.main_modality not in ("rgb", "xyz"):
                raise ValueError("hallucination methods need main_modality in {'rgb','xyz'}")
            if n_fusion_flags != 1:
                raise ValueError("exactly one fusion-module flag must be set for MTFI methods")
            if self.method_name == "WithHallucination" and not (
                    self.use_hn or self.use_hn_conv or self.use_hrnet):
                raise ValueError(
                    "WithHallucination needs use_hn / use_hn_conv / use_hrnet "
                    "(feature- or input-to-feature nets); the FtoI flags "
                    "belong to WithHallucinationFromFeature")
            if self.method_name == "WithHallucinationFromFeature" and not (
                    self.use_hn_from_rgb_mlp or self.use_hn_from_rgb_conv):
                raise ValueError(
                    "WithHallucinationFromFeature needs use_hn_from_rgb_mlp "
                    "or use_hn_from_rgb_conv (feature-to-input nets)")
        if self.dist_method_s not in ("l2", "l1", "cos_dist", "l2_int8"):
            raise ValueError(f"bad dist_method_s {self.dist_method_s!r}")
        if len(self.mesh_shape) > 1:
            raise ValueError(
                f"detection mesh_shape must be 1-D (data-parallel), e.g. "
                f"(8,) — got {self.mesh_shape!r}")
        return self


# Named presets matching the reference README run commands (the JAX
# package's ``config._PRESETS``).  The MTFI presets build a Config;
# ``methods.registry.build_method`` refuses them until MTFI is ported.
_PRESETS = {
    "rgb": dict(method_name="DINO"),
    "xyz": dict(method_name="Point_MAE"),
    "dual": dict(method_name="DINO+Point_MAE"),
    "mtfi_ftof_xyz_main": dict(method_name="WithHallucination", main_modality="xyz", use_hn=True),
    "mtfi_ftof_rgb_main": dict(method_name="WithHallucination", main_modality="rgb", use_hn=True),
    "mtfi_itof_xyz_main": dict(method_name="WithHallucination", main_modality="xyz", use_hrnet=True),
    "mtfi_itof_rgb_main": dict(method_name="WithHallucination", main_modality="rgb", use_hrnet=True),
    "mtfi_ftoi_xyz_main": dict(
        method_name="WithHallucinationFromFeature", main_modality="xyz", use_hn_from_rgb_conv=True),
    "mtfi_ftoi_rgb_main": dict(
        method_name="WithHallucinationFromFeature", main_modality="rgb", use_hn_from_rgb_conv=True),
}


def method_preset(name: str, **overrides) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; choose from {sorted(_PRESETS)}")
    return Config(**{**_PRESETS[name], **overrides}).validate()
