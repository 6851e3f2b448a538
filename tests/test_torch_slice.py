"""The slice as a whole: the port's ``DoubleMethod`` (DINO+Point_MAE) against
the JAX package's, on synthetic samples at 64 px with the small backbones.

Scoring route: on the CPU the JAX package scores an l2 bank exactly, while
the port always selects with the bf16 bank-min product (its kernel's plain
version) and refines exactly.  To compare like with like the JAX routing
gate is patched so the JAX package, too, selects through its bf16 kernel
(interpreted); nothing in the JAX package changes.  The two selections
still differ where two bank rows tie to float32 summation order, which
moves single patch distances (about 1 patch in 10^4 here).

(a) JAX fits, the port serves its saved state (and the other way round):
    scores to 1e-5, maps to the near-tie envelope, metrics to 1e-3.
(b) the port fits by itself: banks before the coreset, Q1 statistics and
    NN tables agree tightly; the coreset draws the JAX package's projection
    and the OCSVM fits in sklearn's order, so the fits differ only by the
    banks' float32 differences: metrics held to 2e-3 (measured 6.1e-4),
    fuser directions to 1e-8 (measured 2.9e-10).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cmdiad_tpu.methods.base as jax_base
import cmdiad_tpu.ops.scoring as jax_scoring
from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
from cmdiad_tpu.models.vit import ViTConfig as JaxViT
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.data.loader import stack_batches
from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
from cmdiad_tpu_torch.models.backbone import DualBackbone, load_jax_params
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import ViTConfig
from cmdiad_tpu_torch.ops.scoring import bank_nn_table
from cmdiad_tpu_torch.runner import CMDIADRunner

torch.set_num_threads(2)

SIZE = 64
SMALL_VIT = dict(img_size=SIZE, patch_size=8, embed_dim=32, depth=2, num_heads=2)
SMALL_PM = dict(num_group=32, group_size=16, encoder_dims=16, trans_dim=16,
                depth=2, num_heads=2, fetch_idx=(0, 1))
CFG = dict(dataset_path="", class_name="widget", rgb_size=SIZE, xyz_size=SIZE,
           gt_size=SIZE, f_coreset=0.5, max_sample=10, batch_size=3)
METRICS = ("image_rocauc", "pixel_rocauc", "au_pro", "au_pro_001")


def _clear_jax_programs():
    jax.clear_caches()
    for fn in vars(jax_base).values():
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


@pytest.fixture(scope="module")
def jax_bf16_selection():
    """Route the JAX package's l2 and l2_int8 scoring through its bf16 and
    int8 bank-min kernels (interpreted on the CPU) for this module, then
    restore the gate."""
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


@pytest.fixture(scope="module")
def fitted(jax_bf16_selection, samples, tmp_path_factory):
    """JAX and port DoubleMethods fitted on the same samples with the same
    (bridged) weights, driven pass by pass so the raw banks can be read."""
    train, test = samples
    jb = JaxBackbone(vit_config=JaxViT(**SMALL_VIT), pm_config=JaxPM(**SMALL_PM),
                     use_pallas=False, image_size=SIZE)
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT),
                      pm_config=PointMAEConfig(**SMALL_PM),
                      device="cpu")
    load_jax_params(tb, params)
    jr = JaxRunner(JaxConfig(**CFG), backbone=jb, params=params)
    tr = CMDIADRunner(Config(**CFG), backbone=tb, device="cpu")
    raw = {}
    for tag, method in (("jax", jr.method), ("port", tr.method)):
        for batch in stack_batches(train, 3):
            method.add_batch_to_mem_bank(batch, class_name="widget")
        raw[tag] = {n: np.concatenate([np.asarray(a) for a in method._bank_acc[n]])
                    for n in ("xyz", "rgb")}
        method.run_coreset()
        for batch in stack_batches(train, 3):
            method.add_batch_to_late_fusion_mem_bank(batch)
        method.run_late_fusion()
    return dict(jr=jr, tr=tr, tb=tb, raw=raw, test=test,
                tmp=tmp_path_factory.mktemp("state"))


def _serve(method, test):
    method.reset_predictions()
    for batch in stack_batches(test, 3):
        method.predict_batch(batch)
    out = method.calculate_metrics()
    return out, np.asarray(method.image_preds), np.stack(method.predictions)


def _assert_predictions_agree(a, b):
    (ma, sa, pa), (mb, sb, pb) = a, b
    np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-7)
    scale = float(np.abs(pb).max())
    diff = np.abs(pa - pb)
    assert diff.max() <= 1e-2 * scale, diff.max() / scale     # near-tie envelope
    assert diff.mean() <= 1e-4 * scale, diff.mean() / scale
    for k in METRICS:
        assert abs(ma[k] - mb[k]) <= 1e-3, (k, ma, mb)


def test_port_serves_jax_fitted_state(fitted):
    jr, test = fitted["jr"], fitted["test"]
    path = os.path.join(fitted["tmp"], "jax.npz")
    jr.method.save_state(path)
    port = CMDIADRunner(Config(**CFG), backbone=fitted["tb"], device="cpu").method
    port.load_state(path)
    assert port.bank_sizes == jr.method.bank_sizes and port.stats == jr.method.stats
    _assert_predictions_agree(_serve(port, test), _serve(jr.method, test))


def test_jax_serves_port_fitted_state(fitted):
    tr, jr, test = fitted["tr"], fitted["jr"], fitted["test"]
    path = os.path.join(fitted["tmp"], "port.npz")
    tr.method.save_state(path)
    jax_method = JaxRunner(JaxConfig(**CFG), backbone=jr.method.backbone,
                           params=jr.method.params).method
    jax_method.load_state(path)
    _assert_predictions_agree(_serve(jax_method, test), _serve(tr.method, test))


def test_state_fingerprint_mismatch_is_refused(fitted):
    from cmdiad_tpu_torch.methods.base import StateFingerprintMismatch
    path = os.path.join(fitted["tmp"], "jax2.npz")
    fitted["jr"].method.save_state(path)
    other = CMDIADRunner(Config(**{**CFG, "n_reweight": 5}), backbone=fitted["tb"],
                         device="cpu").method
    with pytest.raises(StateFingerprintMismatch, match="n_reweight"):
        other.load_state(path)


def test_port_fit_tracks_jax_fit(fitted):
    jm, tm = fitted["jr"].method, fitted["tr"].method
    for n in ("xyz", "rgb"):                      # banks before the coreset
        want = fitted["raw"]["jax"][n]
        np.testing.assert_allclose(fitted["raw"]["port"][n], want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    # Q1: both banks take the xyz mean and the rgb std
    assert tm.stats["xyz"] == tm.stats["rgb"]
    for n in ("xyz", "rgb"):
        assert abs(tm.stats[n][0] - jm.stats[n][0]) < 1e-6
        np.testing.assert_allclose(tm.stats[n][1], jm.stats[n][1], rtol=1e-5)
        assert tm.bank_sizes[n] == jm.bank_sizes[n]
        assert tm.banks[n].shape[0] % 8192 == 0
        # NN tables of the same bank.  The xyz bank holds near-duplicate
        # rows (flat background patches), whose f32 distances by the
        # |a|²+|b|²−2ab identity are cancellation noise;
        # there the neighbour ORDER may differ, so the chosen neighbours are
        # held to equal true (float64) distance within that noise
        nv = jm.bank_sizes[n]
        bank = np.array(jm.banks[n])
        table = bank_nn_table(torch.from_numpy(bank), k=3, n_valid=nv).numpy()[:nv]
        want = np.asarray(jm.nn_tables[n])[:nv]
        assert (table == want).all(1).mean() >= 0.9
        b64 = bank.astype(np.float64)
        d_port = np.linalg.norm(b64[:nv, None] - b64[table], axis=-1)
        d_jax = np.linalg.norm(b64[:nv, None] - b64[want], axis=-1)
        # a few f32 ulps of |a|²+|b|² in d², i.e. its square root in d
        noise = np.sqrt(32 * np.finfo(np.float32).eps * (b64[:nv] ** 2).sum(1).max())
        assert np.abs(d_port - d_jax).max() <= noise
    for f in ("detect_fuser", "seg_fuser"):
        a = np.asarray(getattr(tm, f).coef_).ravel()
        b = np.asarray(getattr(jm, f).coef_).ravel()
        assert 1.0 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) < 1e-8, f
    mt, _, _ = _serve(tm, fitted["test"])
    mj, _, _ = _serve(jm, fitted["test"])
    for k in METRICS:
        assert abs(mt[k] - mj[k]) <= 2e-3, (k, mt, mj)
    assert mt["pixel_rocauc"] > 0.9 and mt["image_rocauc"] > 0.5


THROUGHPUT = dict(compute_dtype="bfloat16", dist_method_s="l2_int8", use_flash=True)
# The JAX package's own envelopes of the default path's metrics, summed:
# bfloat16 backbones (tests/test_e2e.py, 0.01 on pixel AUROC and AU-PRO)
# plus int8 scoring (tests/test_tpu_only.py, 0.02 and 0.05).
THROUGHPUT_ENVELOPE = {"pixel_rocauc": 0.01 + 0.02, "au_pro": 0.01 + 0.05}


def test_throughput_configuration_tracks_jax(fitted, samples):
    """bfloat16 backbones, int8 bank selection and fused attention, fitted
    and evaluated by each package on the same samples and weights.  Both
    select through their int8 kernels (the JAX one interpreted) and refine
    exactly; on the CPU the JAX package runs ``use_flash`` as its einsum
    form, which rounds the scores to bfloat16, while the port runs the fused
    kernel's plain version.  The metrics are held to the envelopes above,
    against the JAX package and against the port's own default path."""
    train, test = samples
    jb = JaxBackbone(vit_config=JaxViT(**SMALL_VIT), pm_config=JaxPM(**SMALL_PM),
                     use_pallas=False, image_size=SIZE, compute_dtype="bfloat16",
                     use_flash=True)
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT),
                      pm_config=PointMAEConfig(**SMALL_PM),
                      compute_dtype="bfloat16", use_flash=True, device="cpu")
    load_jax_params(tb, params)
    runner = CMDIADRunner(Config(**CFG, **THROUGHPUT), backbone=tb, device="cpu")
    runner.fit("widget", train)
    mt = runner.evaluate("widget", test)
    assert set(runner.method._bank_kernel_operands("xyz")) == {"bnorm", "bank_s8", "bscale"}
    jm = JaxRunner(JaxConfig(**CFG, **THROUGHPUT), backbone=jb, params=params).method
    for batch in stack_batches(train, 3):
        jm.add_batch_to_mem_bank(batch, class_name="widget")
    jm.run_coreset()
    for batch in stack_batches(train, 3):
        jm.add_batch_to_late_fusion_mem_bank(batch)
    jm.run_late_fusion()
    mj, _, _ = _serve(jm, test)
    md, _, _ = _serve(fitted["tr"].method, test)
    for k, limit in THROUGHPUT_ENVELOPE.items():
        assert abs(mt[k] - mj[k]) <= limit, (k, mt, mj)
        assert abs(mt[k] - md[k]) <= limit, (k, mt, md)
    assert mt["pixel_rocauc"] > 0.9


def test_runner_fit_and_evaluate(samples):
    """The port's entry points end to end on the CPU: finite metrics in
    [0, 1], one fused map per test sample."""
    train, test = samples
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT),
                      pm_config=PointMAEConfig(**SMALL_PM),
                      device="cpu")
    runner = CMDIADRunner(Config(**{**CFG, "batch_size": 4}), backbone=tb, device="cpu")
    runner.fit("widget", train)
    metrics = runner.evaluate("widget", test)
    assert all(0.0 <= metrics[k] <= 1.0 for k in METRICS), metrics
    assert len(runner.method.predictions) == len(test)
    assert runner.method.bank_sizes == {"xyz": int(0.5 * 5 * 3136),
                                        "rgb": int(0.5 * 5 * 64)}
