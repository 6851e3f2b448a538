"""The port's tail against the JAX package, on the CPU: the bit-exact
quantized blur, JAX's permutation and the ``'jax'`` OCSVM fitter, and the
heatmap renderer.

Tolerances: the quantized blur bit-equal (the same integer arithmetic);
``jax.random.permutation`` equal; the ``'jax'`` fit's coefficients and
offset within 1e-4 relative of ``cmdiad_tpu.fusion.ocsvm._fit_jax``, on
random rows and on ``DoubleMethod``'s fuser rows alike.  Both run the same
float32 steps in the same order; the port's plain version equals a
step-by-step float32 loop bit for bit, and JAX's compiled loop sits within
1e-6 of it (``test_jax_fitter_is_the_float32_recurrence``).  The heatmap's panels
equal ``matplotlib.cm.jet/gray(Normalize()(x), bytes=True)[..., :3]``.
Through ``DoubleMethod`` with ``quantized_blur=True`` (and the ``'jax'``
fitter) the predictions are held to ``test_torch_slice.py``'s default-path
tolerances.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.fusion import ocsvm as jax_ocsvm
from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
from cmdiad_tpu.models.vit import ViTConfig as JaxViT
from cmdiad_tpu.ops import blur as jax_blur
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu.utils import heatmap as jax_heatmap
from cmdiad_tpu_torch import prng
from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.data import png
from cmdiad_tpu_torch.fusion import ocsvm
from cmdiad_tpu_torch.models.backbone import DualBackbone, load_jax_params
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import ViTConfig
from cmdiad_tpu_torch.ops import blur
from cmdiad_tpu_torch.runner import CMDIADRunner
from cmdiad_tpu_torch.utils import heatmap
from test_torch_slice import (CFG, SMALL_PM, SMALL_VIT, _assert_predictions_agree, _serve,
                              jax_bf16_selection, samples)  # noqa: F401 (fixtures)

torch.set_num_threads(2)


# ---------------------------------------------------------------- blur ----

def _maps(rng, shape):
    m = np.abs(rng.normal(size=shape)).astype(np.float32) * 3.0
    m[..., : shape[-2] // 3, :] *= 0.01           # a low region: many small bytes
    return m


@pytest.mark.parametrize("shape", [(224, 224), (3, 64, 64), (2, 2, 17, 23)])
def test_quantized_blur_is_bit_exact(rng, shape):
    maps = _maps(rng, shape)
    if len(shape) > 2:
        maps[0] = 0.0                                  # an all-zero map: max 0
    got = blur.quantized_knn_gaussian_blur(torch.from_numpy(maps)).numpy()
    flat = maps.reshape(-1, *shape[-2:])
    want = np.stack([np.asarray(jax_blur.quantized_knn_gaussian_blur(jnp.asarray(m)))
                     for m in flat]).reshape(shape)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_pillow_box_blur_u8_is_bit_exact(rng):
    img = rng.integers(0, 256, (2, 40, 33)).astype(np.uint8)
    for radius in (1.0, 2.5, 4.0):
        assert blur._pillow_box_params(radius) == jax_blur._pillow_box_params(radius)
        got = blur.pil_gaussian_blur_u8(torch.from_numpy(img), radius).numpy()
        want = np.asarray(jax_blur.pil_gaussian_blur_u8(jnp.asarray(img), radius))
        assert np.array_equal(got, want)


# ---------------------------------------------------------- threefry -----

def test_threefry_keys_and_split_match_jax():
    assert prng.PARTITIONABLE == jax.config.jax_threefry_partitionable
    for seed in (0, 42, 2 ** 31 - 1):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(prng.prng_key(seed).numpy(), np.asarray(key))
        assert np.array_equal(prng.split(prng.prng_key(seed), 5).numpy(),
                              np.asarray(jax.random.split(key, 5)))


@pytest.mark.parametrize("seed,n", [(42, 1), (42, 10), (0, 1625), (42, 1626), (7, 5000),
                                    (3, 70000)])
def test_permutation_equals_jax(seed, n):
    """n up to 1625 sorts once, from 1626 twice."""
    assert prng.shuffle_rounds(n) == (1 if 1 < n <= 1625 else 0 if n <= 1 else 2)
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])
    got = prng.permutations(prng.split(prng.prng_key(seed), 3), n).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------------- 'jax' fitter ----

FIT_RTOL = 1e-4


def _rel_gap(w, rho, want_w, want_rho):
    want_w = np.asarray(want_w, np.float64).ravel()
    return max(float(np.abs(np.ravel(w) - want_w).max() / np.abs(want_w).max()),
               abs(float(np.ravel(rho)[0]) - float(np.ravel(want_rho)[0]))
               / abs(float(np.ravel(want_rho)[0])))


@pytest.mark.parametrize("n,d,max_iter", [(16, 2, 1000), (64, 3, 300), (3000, 2, 20)])
def test_jax_fitter_tracks_jax(rng, n, d, max_iter):
    x = np.abs(rng.normal(size=(n, d))) * rng.uniform(0.5, 3.0, d)
    want = jax_ocsvm.SGDOneClassSVM(max_iter=max_iter, random_state=42, backend="jax").fit(x)
    got = ocsvm.SGDOneClassSVM(max_iter=max_iter, random_state=42, backend="jax",
                               device="cpu").fit(x)
    assert got.coef_.shape == (1, d) and got.offset_.shape == (1,)
    gap = _rel_gap(got.coef_, got.offset_, want.coef_, want.offset_)
    assert gap < FIT_RTOL, gap
    np.testing.assert_allclose(got.score_samples(x), want.score_samples(x), rtol=FIT_RTOL)


def _sequential(x, nu, max_iter, seed, dtype):
    """The JAX fitter's steps one by one, the state in ``dtype``, the step
    sizes computed in float32 as JAX computes them."""
    alpha = nu / 2.0
    t0 = np.float32(1.0 / (alpha * max(1.0, float(np.abs(x).mean()))))
    a32, t = np.float32(alpha), np.float32(1.0)
    rows = x.astype(np.float32).astype(dtype)
    w, rho = np.zeros(x.shape[1], dtype), dtype(0.0)
    keys = prng.split(prng.prng_key(seed), max_iter)
    for order in prng.permutations(keys, len(x)).numpy():
        for i in order:
            eta = dtype(np.float32(1.0) / (a32 * (t0 + t)))
            active = dtype(1.0) if rho - np.dot(w, rows[i]) > 0 else dtype(0.0)
            w = w - eta * (dtype(a32) * w - active * rows[i])
            rho = rho - eta * (active - dtype(np.float32(nu)))
            t = np.float32(t + np.float32(1.0))
    return w, rho


def test_jax_fitter_is_the_float32_recurrence(rng, monkeypatch):
    """The port's plain version is the float32 loop step by step, bit for
    bit, also when the state crosses launches (three epochs a launch), and
    JAX's compiled loop lies within 1e-6 of both."""
    x = np.abs(rng.normal(size=(200, 2))) * [0.01, 0.02]
    w32, rho32 = _sequential(x, 0.5, 10, 42, np.float32)
    w, rho = ocsvm._fit_jax(x, 0.5, 10, 42, "cpu")
    assert np.array_equal(w.astype(np.float32), w32) and np.float32(rho) == rho32
    monkeypatch.setattr(ocsvm, "LAUNCH_ROWS", 3 * len(x))
    w3, rho3 = ocsvm._fit_jax(x, 0.5, 10, 42, "cpu")
    assert np.array_equal(w3, w) and rho3 == rho
    jw, jrho = jax_ocsvm._fit_jax(x, 0.5, 10, 42)
    assert _rel_gap(jw, jrho, w32, [rho32]) < 1e-6
    assert _rel_gap(w, [rho], jw, jrho) < 1e-6


def test_jax_fitter_refuses_rows_wider_than_its_state(rng):
    """The kernel's state holds ``MAX_D`` columns; both devices refuse more."""
    x = np.abs(rng.normal(size=(8, ocsvm.MAX_D + 1)))
    with pytest.raises(ValueError, match="columns"):
        ocsvm.SGDOneClassSVM(backend="jax", device="cpu").fit(x)


def test_unknown_ocsvm_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        ocsvm.SGDOneClassSVM(backend="libsvm")


def test_quantized_blur_and_jax_fitter_through_double_method(jax_bf16_selection, samples,
                                                             tmp_path, monkeypatch):
    """``Config(quantized_blur=True, ocsvm_backend='jax')`` fits and
    predicts in the port; each fuser's fit matches JAX's ``_fit_jax`` on the
    rows it was given; the JAX package serves the port's saved state with
    predictions within the default path's tolerances."""
    train, test = samples
    cfg = dict(CFG, quantized_blur=True, ocsvm_backend="jax", ocsvm_maxiter=50)
    jb = JaxBackbone(vit_config=JaxViT(**SMALL_VIT), pm_config=JaxPM(**SMALL_PM),
                     use_pallas=False, image_size=CFG["rgb_size"])
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT), pm_config=PointMAEConfig(**SMALL_PM),
                      device="cpu")
    load_jax_params(tb, params)
    rows = []
    fit = ocsvm.SGDOneClassSVM.fit
    monkeypatch.setattr(ocsvm.SGDOneClassSVM, "fit",
                        lambda self, x: (rows.append(np.array(x)), fit(self, x))[1])
    runner = CMDIADRunner(Config(**cfg), backbone=tb, device="cpu")
    runner.fit("widget", train)
    port = runner.method
    assert len(rows) == 2
    for fuser, x in zip((port.detect_fuser, port.seg_fuser), rows):
        assert fuser.backend == "jax"
        w, rho = jax_ocsvm._fit_jax(x, 0.5, 50, 42)
        assert _rel_gap(fuser.coef_, fuser.offset_, w, rho) < FIT_RTOL
    path = os.path.join(tmp_path, "port.npz")
    port.save_state(path)
    jax_method = JaxRunner(JaxConfig(**cfg), backbone=jb, params=params).method
    jax_method.load_state(path)
    got, want = _serve(port, test), _serve(jax_method, test)
    _assert_predictions_agree(got, want)
    # the maps are the uint8 staircase: every value a multiple of max / 255
    # before fusion, so the fused map takes few distinct values
    assert len(np.unique(got[2][0])) < 0.5 * got[2][0].size


# ------------------------------------------------------------ heatmap ----

def _mpl(name, x):
    from matplotlib import cm, colors
    return getattr(cm, name)(colors.Normalize()(x), bytes=True)[..., :3]


@pytest.mark.parametrize("kind", ["float64", "float32", "uint8", "constant", "nan", "int64"])
def test_heatmap_colours_match_matplotlib(rng, kind):
    x = rng.normal(size=(31, 29))
    if kind == "float32":
        x = x.astype(np.float32)
    elif kind == "uint8":
        x = rng.integers(0, 2, (31, 29)).astype(np.uint8) * 255
    elif kind == "constant":
        x = np.full((31, 29), 0.7)
    elif kind == "nan":
        x[3, 4] = np.nan
    elif kind == "int64":
        x = rng.integers(-5, 900, (31, 29))
    for name in ("jet", "gray"):
        assert np.array_equal(heatmap.colourize(x, name), _mpl(name, x)), name
    assert np.array_equal(heatmap.colour_table("jet"), _mpl("jet", np.linspace(0, 1, 256)))


def test_render_heatmap_panels(rng, tmp_path):
    s_map = rng.normal(size=(40, 40)) ** 2
    gt = (rng.random((40, 40)) > 0.7).astype(np.float32)
    rgb = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    out = heatmap.render_heatmap(s_map, str(tmp_path / "a" / "h.png"), rgb=rgb, gt=gt)
    img = png.imread(out)
    assert img.shape == (40, 3 * 40 + 2 * heatmap.GAP, 3)
    g = heatmap.GAP
    assert np.array_equal(img[:, :40], rgb)
    assert np.array_equal(img[:, 40 + g:80 + g], _mpl("gray", gt))
    assert np.array_equal(img[:, 80 + 2 * g:], _mpl("jet", s_map))
    assert (img[:, 40:40 + g] == 255).all()
    only = png.imread(heatmap.render_heatmap(s_map, str(tmp_path / "b.png")))
    assert np.array_equal(only, _mpl("jet", s_map))


def test_render_run_names_and_cli(rng, tmp_path, capsys):
    """The same file names as the JAX package's ``render_run`` (relative
    path parts joined by ``_``), ``limit`` honoured, through the CLI."""
    from cmdiad_tpu_torch import cli
    seg = tmp_path / "seg"
    for cls in ("bagel", "cookie"):
        (seg / cls).mkdir(parents=True)
        for i in range(2):
            np.savez_compressed(seg / cls / f"{i:03d}.npz", s_map=rng.random((24, 24)),
                                gt=(rng.random((24, 24)) > 0.5).astype(np.float32))
    assert jax_heatmap.render_run(str(seg), str(tmp_path / "jax")) == 4
    assert cli.main(["heatmap", "--seg_dir", str(seg), "--out_dir", str(tmp_path / "port")]) == 4
    assert "4 heatmaps rendered" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names[0] == "bagel_000.png"
    assert heatmap.render_run(str(seg), str(tmp_path / "lim"), limit=3) == 3
    assert sorted(os.listdir(tmp_path / "lim")) == names[:3]
    with np.load(seg / "bagel" / "000.npz") as z:
        img = png.imread(tmp_path / "port" / "bagel_000.png")
        assert np.array_equal(img[:, :24], _mpl("gray", z["gt"]))
        assert np.array_equal(img[:, 24 + heatmap.GAP:], _mpl("jet", z["s_map"]))
