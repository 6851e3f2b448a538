"""MTFI few-modal inference: the port's ``WithHallucination`` and
``WithHallucinationFromFeature`` against the JAX package's, for each of the
six ``mtfi_*`` presets, on synthetic samples at 64 px with the small
backbones and the JAX package's random fusion net, bridged.

As in ``test_torch_slice.py`` the JAX package's l2 scoring selects through
its bf16 bank-min kernel (interpreted) so both packages select bank rows
the same way.

* the JAX runner fits; the port serves that fitted state with the same
  fusion net: scores to 1e-5, maps within the near-tie envelope (max 1e-2,
  mean 1e-4 of the map maximum), metrics to 1e-3;
* the port fits by itself in the presets' configuration (the greedy
  coreset in bfloat16): the kept banks before the coreset agree with the
  JAX package's to 1e-5, the port's coreset on the JAX package's bank picks
  the JAX package's rows exactly, the bank sizes are equal, the stats-only
  bank keeps no rows, the Q1 statistics agree (std to 1e-5, mean to 1e-6
  absolute), the metrics to 5e-3 (the same OCSVM order, but the bfloat16
  picks on the two packages' own banks may differ where float32-level
  feature differences reorder near-equal distances; measured 3.7e-3 at
  most, FtoI rgb main's pixel AUROC);
* evaluation batches without the other modality's keys give the same
  predictions, and the other backbone runs on nothing but hallucinated
  input;
* one preset in the throughput configuration (bfloat16, ``l2_int8``,
  ``use_flash``), fitted by each package, metrics within the JAX
  package's own envelopes (``test_torch_slice.py``).
"""

import numpy as np
import pytest
import torch

import jax

import cmdiad_tpu.methods.base as jax_base
import cmdiad_tpu_torch.methods.base as port_base
import cmdiad_tpu.ops.scoring as jax_scoring
from cmdiad_tpu.config import method_preset as jax_preset
from cmdiad_tpu.methods import registry as jax_registry
from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
from cmdiad_tpu.models.vit import ViTConfig as JaxViT
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu_torch.config import method_preset
from cmdiad_tpu_torch.data.loader import stack_batches
from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
from cmdiad_tpu_torch.methods import registry
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.models.backbone import DualBackbone, load_jax_params
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import ViTConfig
from cmdiad_tpu_torch.ops.coreset import coreset_select
from cmdiad_tpu_torch.runner import CMDIADRunner

torch.set_num_threads(2)

SIZE = 64
SMALL_VIT = dict(img_size=SIZE, patch_size=8, embed_dim=32, depth=2, num_heads=2)
SMALL_PM = dict(num_group=32, group_size=16, encoder_dims=16, trans_dim=16,
                depth=2, num_heads=2, fetch_idx=(0, 1))
KW = dict(rgb_size=SIZE, xyz_size=SIZE, gt_size=SIZE, batch_size=3)
METRICS = ("image_rocauc", "pixel_rocauc", "au_pro", "au_pro_001")
PRESETS = ("mtfi_ftof_xyz_main", "mtfi_ftof_rgb_main", "mtfi_itof_xyz_main",
           "mtfi_itof_rgb_main", "mtfi_ftoi_xyz_main", "mtfi_ftoi_rgb_main")
THROUGHPUT = dict(compute_dtype="bfloat16", dist_method_s="l2_int8", use_flash=True)
THROUGHPUT_ENVELOPE = {"pixel_rocauc": 0.01 + 0.02, "au_pro": 0.01 + 0.05}


def _clear_jax_programs():
    jax.clear_caches()
    for fn in vars(jax_base).values():
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


@pytest.fixture(scope="module")
def jax_bf16_selection():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_scoring, "use_scoring_kernel",
               lambda rows, metric: (metric in ("l2", "l2_int8")
                                     and rows % 1024 == 0))
    _clear_jax_programs()
    yield
    mp.undo()
    _clear_jax_programs()


@pytest.fixture(scope="module")
def samples():
    return make_synthetic_samples(n_train=5, n_test_good=3, n_test_bad=3,
                                  size=SIZE, seed=0, anomaly_radius=(0.13, 0.18))


def _backbones(dtype="float32", use_flash=False):
    jb = JaxBackbone(vit_config=JaxViT(**SMALL_VIT), pm_config=JaxPM(**SMALL_PM),
                     use_pallas=False, image_size=SIZE, compute_dtype=dtype,
                     use_flash=use_flash)
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT),
                      pm_config=PointMAEConfig(**SMALL_PM), compute_dtype=dtype,
                      use_flash=use_flash, device="cpu")
    load_jax_params(tb, params)
    return jb, params, tb


def _recording(mp, module):
    """Record each (bank, picked rows) that ``module``'s coreset_select
    is called with and returns."""
    seen, real = [], module.coreset_select

    def record(bank, *a, **k):
        idx = real(bank, *a, **k)
        seen.append((np.array(bank), np.array(idx)))
        return idx
    mp.setattr(module, "coreset_select", record)
    return seen


def _bridged_fusion(cfg, tb, jax_vars):
    """The port's fusion net of ``cfg`` carrying the JAX net's variables."""
    net = registry.build_fusion(cfg, tb, "cpu")
    variables = jax.device_get(jax_vars)
    table = (names.ftof_mlp(len(variables["params"]["xyz_mlp"])) if cfg.use_hn
             else names.hrnet() if cfg.use_hrnet else names.ftoi_conv())
    net.load_state_dict(names.to_torch(table, variables))
    return net


@pytest.fixture(scope="module")
def fits(jax_bf16_selection, samples, tmp_path_factory):
    """preset -> the JAX fit, its metrics, state file and coreset inputs
    and picks, and the port's backbone and bridged fusion net (computed
    once a preset)."""
    jb, params, tb = _backbones()
    tmp = tmp_path_factory.mktemp("mtfi")
    cache = {}

    def get(preset):
        if preset not in cache:
            train, test = samples
            jcfg = jax_preset(preset, **KW)
            jnet, jvars = jax_registry.build_fusion(jcfg, jb)
            jr = JaxRunner(jcfg, backbone=jb, params=params, fusion=jnet,
                           fusion_vars=jvars)
            with pytest.MonkeyPatch.context() as mp:
                jax_coreset = _recording(mp, jax_base)
                jr.fit("widget", train)
            mj = jr.evaluate("widget", test)
            state = str(tmp / f"{preset}.npz")
            jr.method.save_state(state)
            cfg = method_preset(preset, **KW)
            cache[preset] = dict(jr=jr, mj=mj, state=state, cfg=cfg, tb=tb,
                                 fusion=_bridged_fusion(cfg, tb, jvars),
                                 jax_coreset=jax_coreset)
        return cache[preset]
    return get


def _serve(method, batches):
    method.reset_predictions()
    for batch in batches:
        method.predict_batch(batch)
    return (method.calculate_metrics(), np.asarray(method.image_preds),
            np.stack(method.predictions))


def _served(fit):
    method = registry.build_method(fit["cfg"], backbone=fit["tb"], fusion=fit["fusion"])
    method.load_state(fit["state"])
    return method


@pytest.mark.parametrize("preset", PRESETS)
def test_mtfi_preset_tracks_jax(fits, samples, monkeypatch, preset):
    fit = fits(preset)
    jm, train, test = fit["jr"].method, *samples
    main = fit["cfg"].main_modality
    assert set(jm.banks) == {main, "fusion"} and set(jm.stats) == {"rgb", "xyz", "fusion"}

    # the port serves the JAX fit
    served = _served(fit)
    assert served.bank_sizes == jm.bank_sizes and served.stats == jm.stats
    ms, ss, maps_s = _serve(served, stack_batches(test, 3))
    sj, maps_j = np.asarray(jm.image_preds), np.stack(jm.predictions)
    np.testing.assert_allclose(ss, sj, rtol=1e-5, atol=1e-7)
    scale = float(np.abs(maps_j).max())
    diff = np.abs(maps_s - maps_j)
    assert diff.max() <= 1e-2 * scale, diff.max() / scale
    assert diff.mean() <= 1e-4 * scale, diff.mean() / scale
    for k in METRICS:
        assert abs(ms[k] - fit["mj"][k]) <= 1e-3, (k, ms, fit["mj"])

    # the port's own fit
    cfg = fit["cfg"]
    assert cfg.coreset_dtype == "FP16"          # the presets' configuration
    own = CMDIADRunner(cfg, backbone=fit["tb"], device="cpu", fusion=fit["fusion"])
    port_coreset = _recording(monkeypatch, port_base)
    own.fit("widget", train)
    mo = own.evaluate("widget", test)
    om = own.method
    assert om.bank_sizes == jm.bank_sizes
    # each kept bank, normalised, before the coreset; the port's coreset on
    # the JAX package's bank picks the JAX package's rows, in order
    kept = [n for n in jm.bank_names if n in (main, "fusion")]
    assert len(port_coreset) == len(fit["jax_coreset"]) == len(kept)
    for n, (jbank, jidx), (pbank, _) in zip(kept, fit["jax_coreset"], port_coreset):
        np.testing.assert_allclose(pbank, jbank, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jbank).max()), err_msg=n)
        picks = coreset_select(torch.from_numpy(jbank), cfg.f_coreset,
                               eps=cfg.coreset_eps, seed=cfg.random_state or 0,
                               metric=cfg.dist_method_coreset,
                               compute_dtype=cfg.coreset_dtype)
        np.testing.assert_array_equal(picks.numpy(), jidx, err_msg=n)
    other = "xyz" if main == "rgb" else "rgb"
    assert other not in om.banks and not om._bank_acc[other] and not om._stats_acc
    for n in ("rgb", "xyz", "fusion"):
        # the xyz mean is a mean of LayerNorm outputs, zero to float32
        # rounding: held absolutely, as test_torch_slice.py holds it
        assert abs(om.stats[n][0] - jm.stats[n][0]) < 1e-6
        np.testing.assert_allclose(om.stats[n][1], jm.stats[n][1], rtol=1e-5)
    for k in METRICS:
        assert abs(mo[k] - fit["mj"][k]) <= 5e-3, (k, mo, fit["mj"])


@pytest.mark.parametrize("preset", PRESETS)
def test_few_modal_inference_reads_only_the_main_modality(fits, samples, monkeypatch,
                                                          preset):
    """Batches that lack the other modality's keys predict the same as
    batches that carry them; the other backbone never sees a sample's own
    input (FtoF and ItoF never run it; FtoI runs it on the hallucinated
    input alone)."""
    fit = fits(preset)
    cfg, tb = fit["cfg"], fit["tb"]
    test = samples[1]
    served = _served(fit)
    _, s_full, maps_full = _serve(served, stack_batches(test, 3))
    keep = ("rgb",) if cfg.main_modality == "rgb" else ("organized_pc", "points_compact")
    strip = ("organized_pc", "points_compact", "depth3", "rgb")
    few = [{k: v for k, v in s.items() if k in keep or k not in strip} for s in test]
    seen = []
    other = "xyz_patches" if cfg.main_modality == "rgb" else "rgb_patches"
    real = getattr(tb, other)

    def watch(x, *a, **k):
        seen.append(x)
        if cfg.method_name == "WithHallucination":
            raise AssertionError(f"{preset} ran {other}")
        return real(x, *a, **k)

    monkeypatch.setattr(tb, other, watch)
    _, s_few, maps_few = _serve(served, stack_batches(few, 3))
    np.testing.assert_array_equal(s_few, s_full)
    np.testing.assert_array_equal(maps_few, maps_full)
    if cfg.method_name == "WithHallucinationFromFeature":
        inputs = [s["organized_pc" if other == "xyz_patches" else "rgb"] for s in test]
        assert len(seen) == 2 and all(
            not np.allclose(x[0].numpy(), a) for x in seen for a in inputs)


def test_throughput_configuration_tracks_jax(jax_bf16_selection, samples):
    """bfloat16 backbones and fusion net, int8 bank selection, fused
    attention: each package fits and evaluates the xyz-main FtoF preset."""
    train, test = samples
    jb, params, tb = _backbones("bfloat16", use_flash=True)
    jcfg = jax_preset("mtfi_ftof_xyz_main", **KW, **THROUGHPUT)
    jnet, jvars = jax_registry.build_fusion(jcfg, jb)
    jr = JaxRunner(jcfg, backbone=jb, params=params, fusion=jnet, fusion_vars=jvars)
    jr.fit("widget", train)
    mj = jr.evaluate("widget", test)
    cfg = method_preset("mtfi_ftof_xyz_main", **KW, **THROUGHPUT)
    fusion = _bridged_fusion(cfg, tb, jvars)
    assert fusion.dtype == torch.bfloat16
    runner = CMDIADRunner(cfg, backbone=tb, device="cpu", fusion=fusion)
    runner.fit("widget", train)
    mt = runner.evaluate("widget", test)
    assert set(runner.method._bank_kernel_operands("fusion")) == {"bnorm", "bank_s8",
                                                                  "bscale"}
    for k, limit in THROUGHPUT_ENVELOPE.items():
        assert abs(mt[k] - mj[k]) <= limit, (k, mt, mj)
