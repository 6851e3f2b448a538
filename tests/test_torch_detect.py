"""``detect`` from a dataset on disk: the port against the JAX package.

Both packages read the same 64² fixture (written by the JAX package's
``make_synthetic_dataset``) with the small backbones, the port's weights
bridged from the JAX parameters.  As in ``test_torch_slice.py`` the JAX
package's l2 scoring is routed through its bf16 bank-min kernel
(interpreted) so both select bank rows the same way.

* ``DINO``, ``Point_MAE`` and ``Depth``: the port serves the JAX fit with
  the slice's prediction tolerances (scores 1e-5, maps within the near-tie
  envelope, metrics 1e-3), writing the same ``save_seg_results`` and
  ``save_raw_results`` files; the port's own fit tracks the JAX fit's
  metrics to 1e-4 (the same coreset projection and OCSVM order; measured
  4.1e-6 at most, from the backbones' float32 differences);
* ``run_detection`` over two classes, the second preloaded on a thread;
* ``python -m cmdiad_tpu_torch.cli detect --device cpu``, whose tables are
  pandas' ``to_markdown(index=False)`` text;
* the fitted-state cache (served, stale, pre-fingerprint, truncated), the
  refused config fields and ``needed_keys``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import cmdiad_tpu.methods.base as jax_base
import cmdiad_tpu.ops.scoring as jax_scoring
from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.data.synthetic import make_synthetic_dataset
from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
from cmdiad_tpu.models.vit import ViTConfig as JaxViT
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu.runner import run_detection as jax_run_detection
from cmdiad_tpu_torch import cli
from cmdiad_tpu_torch.config import Config, method_preset
from cmdiad_tpu_torch.methods.registry import build_method
from cmdiad_tpu_torch.models.backbone import DualBackbone
from cmdiad_tpu_torch.models.bridge import load_jax_params
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import ViTConfig
from cmdiad_tpu_torch.runner import CMDIADRunner, run_detection

torch.set_num_threads(2)

SIZE = 64
SMALL_VIT = dict(img_size=SIZE, patch_size=8, embed_dim=32, depth=2, num_heads=2)
SMALL_PM = dict(num_group=32, group_size=16, encoder_dims=16, trans_dim=16,
                depth=2, num_heads=2, fetch_idx=(0, 1))
METRICS = ("image_rocauc", "pixel_rocauc", "au_pro", "au_pro_001")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clear_jax_programs():
    jax.clear_caches()
    for fn in vars(jax_base).values():
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


@pytest.fixture(scope="module")
def jax_bf16_selection():
    """The JAX package's l2 scoring through its bf16 bank-min kernel
    (interpreted) for this module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_scoring, "use_scoring_kernel",
               lambda rows, metric: (metric in ("l2", "l2_int8")
                                     and rows % 1024 == 0))
    _clear_jax_programs()
    yield
    mp.undo()
    _clear_jax_programs()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_dataset(
        str(tmp_path_factory.mktemp("mvtec")), class_names=("widget", "gadget"),
        n_train=4, n_test_good=3, n_test_bad=2, n_test_color=1, size=SIZE, seed=0,
        anomaly_radius=(0.13, 0.18))


@pytest.fixture(scope="module")
def backbones():
    jb = JaxBackbone(vit_config=JaxViT(**SMALL_VIT), pm_config=JaxPM(**SMALL_PM),
                     use_pallas=False, image_size=SIZE)
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT),
                      pm_config=PointMAEConfig(**SMALL_PM), device="cpu")
    load_jax_params(tb, params)
    return jb, params, tb


def _cfg(root, **kw):
    return {**dict(dataset_path=root, rgb_size=SIZE, xyz_size=SIZE, gt_size=SIZE,
                   f_coreset=0.5, max_sample=10, batch_size=3), **kw}


def _predictions(method):
    return (np.asarray(method.image_preds), np.stack(method.predictions))


def _assert_predictions_agree(ma, pa, mb, pb):
    """test_torch_slice.py's tolerances for two packages serving one state."""
    (sa, maps_a), (sb, maps_b) = pa, pb
    np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-7)
    scale = float(np.abs(maps_b).max())
    diff = np.abs(maps_a - maps_b)
    assert diff.max() <= 1e-2 * scale, diff.max() / scale
    assert diff.mean() <= 1e-4 * scale, diff.mean() / scale
    for k in METRICS:
        assert abs(ma[k] - mb[k]) <= 1e-3, (k, ma, mb)


@pytest.mark.parametrize("method", ["DINO", "Point_MAE", "Depth"])
def test_single_modal_method_tracks_jax(jax_bf16_selection, root, backbones,
                                        tmp_path, method):
    jb, params, tb = backbones
    out = {p: str(tmp_path / p) for p in ("jax", "port", "cache")}
    save = dict(save_seg_results=True, save_raw_results=True)
    jr = JaxRunner(JaxConfig(**_cfg(root, method_name=method, results_dir=out["jax"],
                                    **save)), backbone=jb, params=params)
    jr.fit("widget")
    mj = jr.evaluate("widget")
    state = os.path.join(out["cache"], "widget.npz")
    os.makedirs(out["cache"])
    jr.method.save_state(state)
    assert set(jr.method.banks) == {"DINO": {"rgb"}, "Depth": {"rgb"},
                                    "Point_MAE": {"xyz"}}[method]

    # the port serves the JAX fit through the cache, writing result files
    served = CMDIADRunner(Config(**_cfg(root, method_name=method, results_dir=out["port"],
                                        bank_cache_dir=out["cache"], **save)),
                          backbone=tb, device="cpu")
    served.fit("widget")
    assert "bank_load_s" in served.timings and "bank_pass_s" not in served.timings
    ms = served.evaluate("widget")
    _assert_predictions_agree(ms, _predictions(served.method), mj, _predictions(jr.method))
    for sub in ("segmentation/widget", "raw"):
        assert sorted(os.listdir(os.path.join(out["port"], sub))) == \
            sorted(os.listdir(os.path.join(out["jax"], sub)))
    for name in os.listdir(os.path.join(out["jax"], "segmentation/widget")):
        with np.load(os.path.join(out["port"], "segmentation/widget", name)) as a, \
                np.load(os.path.join(out["jax"], "segmentation/widget", name)) as b:
            assert sorted(a.files) == sorted(b.files) == ["gt", "s_map"]
            assert np.array_equal(a["gt"], b["gt"])
            scale = float(np.abs(b["s_map"]).max())
            assert np.abs(a["s_map"] - b["s_map"]).max() <= 1e-2 * scale
    rows = [[ln.split(",") for ln in open(os.path.join(out[p], "raw/widget_raw_results.csv"))]
            for p in ("port", "jax")]
    assert [r[1:] for r in rows[0]] == [r[1:] for r in rows[1]]
    np.testing.assert_allclose([float(r[0]) for r in rows[0]],
                               [float(r[0]) for r in rows[1]], rtol=1e-5, atol=1e-7)

    # the port's own fit from disk
    own = CMDIADRunner(Config(**_cfg(root, method_name=method)), backbone=tb, device="cpu")
    own.fit("widget")
    mo = own.evaluate("widget")
    assert set(own.method.banks) == set(jr.method.banks)
    for n in own.method.banks:
        assert own.method.bank_sizes[n] == jr.method.bank_sizes[n]
        np.testing.assert_allclose(own.method.stats[n], jr.method.stats[n], rtol=1e-5,
                                   atol=1e-6)
    for k in METRICS:
        assert abs(mo[k] - mj[k]) <= 1e-4, (k, mo, mj)


def test_run_detection_over_two_classes_tracks_jax(jax_bf16_selection, root, backbones):
    jb, params, tb = backbones
    kw = _cfg(root, method_name="DINO", save_results=False)
    done = []
    mt = run_detection(Config(**kw), ["widget", "gadget"], backbone=tb,
                       on_class_done=lambda c, m, t: done.append((c, dict(t))))
    mj = jax_run_detection(JaxConfig(**kw), ["widget", "gadget"], backbone=jb,
                           params=params)
    assert list(mt) == list(mj) == ["widget", "gadget"]
    for cls in mt:
        for k in METRICS:
            assert abs(mt[cls][k] - mj[cls][k]) <= 1e-4, (cls, k, mt, mj)
    assert [c for c, _ in done] == ["widget", "gadget"]
    assert all(t["eval_images_per_s"] > 0 and "bank_pass_s" in t for _, t in done)


def test_run_detection_raises_a_failed_preload(root, backbones):
    """The next class is decoded on a thread; its failure is raised, not
    swallowed."""
    kw = _cfg(root, method_name="DINO", f_coreset=1.0)
    with pytest.raises(RuntimeError, match="nowhere") as info:
        run_detection(Config(**kw), ["widget", "nowhere"], backbone=backbones[2])
    assert info.value.__cause__ is not None


def test_cli_detect_on_cpu_prints_pandas_tables(root, tmp_path):
    """The module entry point end to end in a fresh interpreter, with the
    CLI's own random tiny backbones and a torch.profiler trace."""
    args = ["detect", "--device", "cpu", "--method_name", "DINO",
            "--rgb_backbone_name", "tiny", "--xyz_backbone_name", "tiny",
            "--dataset_path", root, "--class_name", "gadget",
            "--rgb_size", str(SIZE), "--xyz_size", str(SIZE), "--gt_size", str(SIZE),
            "--f_coreset", "0.5", "--batch_size", "3",
            "--results_dir", str(tmp_path / "res"), "--experiment_note", "note",
            "--trace_dir", str(tmp_path / "trace"), "--save_raw_results", "true"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-m", "cmdiad_tpu_torch.cli", *args],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "trace" / "trace.json").exists()
    json.loads((tmp_path / "trace" / "trace.json").read_text())
    scores = [float(ln.split(",")[0])
              for ln in open(tmp_path / "res" / "raw" / "gadget_raw_results.csv")]
    assert len(scores) == 6 and np.all(np.isfinite(scores))
    files = {"image_rocauc": "image_rocauc_results.md",
             "pixel_rocauc": "pixel_rocauc_results.md",
             "au_pro": "aupro_results.md", "au_pro_001": "aupro_001_results.md"}
    for k, name in files.items():
        block = proc.stdout.split(f"===== {k} =====\n")[1].split("\n\n")[0].strip()
        value = float(block.splitlines()[2].split("|")[2])
        # the JAX CLI's pandas table for the same row
        df = pd.DataFrame([{"Method": "DINO", "Gadget": value}])
        df["Mean"] = round(df.iloc[:, 1:].mean(axis=1).iloc[0], 3)
        assert block == df.to_markdown(index=False)
        assert (tmp_path / "res" / name).read_text() == "\n\nnote\n" + block


def test_result_tables_equal_pandas_to_markdown():
    """Ten classes of random metrics, many rounding to a tie at the 4th
    place of the mean: the text is pandas' for the JAX CLI's rows."""
    rng = np.random.default_rng(0)
    classes = ["bagel", "cable_gland", "carrot", "cookie", "dowel", "foam",
               "peach", "potato", "rope", "tire"]
    for trial in range(40):
        n = 1 + trial % len(classes)
        results = {c: {k: float(rng.choice([rng.uniform(), 1.0, 0.0, 0.5]))
                       for k in METRICS} for c in classes[:n]}
        cfg = Config(method_name="DINO+Point_MAE", save_results=False)
        for k, (headers, row) in cli.result_rows(cfg, results).items():
            tables = {c: round(results[c][k], 3) for c in results}
            df = pd.DataFrame([{"Method": cfg.method_name,
                                **{c.title(): v for c, v in tables.items()}}])
            df["Mean"] = round(df.iloc[:, 1:].mean(axis=1).iloc[0], 3)
            assert cli.markdown_table(headers, [row]) == df.to_markdown(index=False)
    rows = [["D", 0.25, 1e-05], ["DINO+Point_MAE", 12.5, 3.0], ["x", 3.0, 0.125]]
    df = pd.DataFrame(rows, columns=["Method", "A", "Long header"])
    assert cli.markdown_table(list(df.columns), rows) == df.to_markdown(index=False)


def test_parse_int_tuple():
    assert cli._parse_int_tuple("") == ()
    assert cli._parse_int_tuple("8") == (8,)
    assert cli._parse_int_tuple("(4, 2)") == (4, 2)


@pytest.fixture(scope="module")
def cache_fit(root, backbones, tmp_path_factory):
    """A DINO fit persisted to a cache directory; -> (cfg, metrics, path)."""
    cache = str(tmp_path_factory.mktemp("banks"))
    cfg = Config(**_cfg(root, method_name="DINO", bank_cache_dir=cache))
    runner = CMDIADRunner(cfg, backbone=backbones[2], device="cpu")
    runner.fit("widget")
    assert "bank_pass_s" in runner.timings
    return cfg, runner.evaluate("widget"), os.path.join(cache, "widget.npz")


def _spoil(path, how):
    if how == "stale":
        return {"n_reweight": 5}
    z = dict(np.load(path))
    if how == "prefingerprint":
        meta = json.loads(bytes(z["meta_json"]).decode())
        del meta["fingerprint"]
        z["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
        with open(path, "wb") as fh:
            np.savez_compressed(fh, **z)
    else:
        data = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data[:len(data) // 2])
    return {}


@pytest.mark.parametrize("how", ["served", "stale", "prefingerprint", "truncated"])
def test_fitted_state_cache(cache_fit, backbones, how, tmp_path):
    cfg, metrics, path = cache_fit
    cache = str(tmp_path / "banks")
    os.makedirs(cache)
    mine = os.path.join(cache, "widget.npz")
    with open(path, "rb") as src, open(mine, "wb") as dst:
        dst.write(src.read())
    changes = {} if how == "served" else _spoil(mine, how)
    cfg = cfg.replace(bank_cache_dir=cache, **changes)
    runner = CMDIADRunner(cfg, backbone=backbones[2], device="cpu")
    runner.fit("widget")
    if how == "served":
        assert "bank_load_s" in runner.timings and "bank_pass_s" not in runner.timings
        assert runner.evaluate("widget") == metrics
        return
    assert "bank_pass_s" in runner.timings and "bank_load_s" not in runner.timings
    # the refit was persisted: the same config is now served from it
    again = CMDIADRunner(cfg, backbone=backbones[2], device="cpu")
    again.fit("widget")
    assert "bank_load_s" in again.timings


@pytest.mark.parametrize("field", [dict(mesh_shape=(8,)), dict(shard_bank=True),
                                   dict(ocsvm_backend="libsvm")])
def test_unhonoured_fields_raise(backbones, cache_fit, field):
    """An unknown ``ocsvm_backend`` raises ``ValueError`` (the JAX
    package's 'sklearn' and 'jax' are both ported); ``mesh_shape`` needs a
    process group and, without one, names torchrun; ``shard_bank`` without
    one is one shard, the whole bank, scoring exactly as the unsharded
    method (the JAX package on one device)."""
    if "ocsvm_backend" in field:
        with pytest.raises(ValueError, match="ocsvm backend 'libsvm'"):
            build_method(Config(rgb_size=SIZE, **field), backbone=backbones[2])
    elif "mesh_shape" in field:
        with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 8"):
            build_method(Config(rgb_size=SIZE, **field), backbone=backbones[2])
    else:
        cfg, metrics, _ = cache_fit
        runner = CMDIADRunner(cfg.replace(**field), backbone=backbones[2], device="cpu")
        runner.fit("widget")                      # served from the cache
        assert "bank_load_s" in runner.timings
        assert runner.method.bank_mesh is None
        assert runner.method.banks["rgb"].shape[0] == 8192
        assert runner.evaluate("widget") == metrics


@pytest.mark.parametrize("method,absent", [("DINO", "xyz_patches"),
                                           ("Depth", "xyz_patches"),
                                           ("Point_MAE", "rgb_patches")])
def test_needed_keys_keep_the_other_backbone_idle(root, backbones, monkeypatch,
                                                  method, absent):
    """DINO and Depth never run Point-MAE, Point_MAE never runs the ViT;
    Depth feeds the depth map to the ViT."""
    tb = backbones[2]

    def refuse(*a, **k):
        raise AssertionError(f"{method} ran {absent}")

    seen = []
    rgb_patches = tb.rgb_patches
    monkeypatch.setattr(tb, absent, refuse)
    if method != "Point_MAE":
        monkeypatch.setattr(tb, "rgb_patches",
                            lambda images: seen.append(images) or rgb_patches(images))
    runner = CMDIADRunner(Config(**_cfg(root, method_name=method, max_sample=2)),
                          backbone=tb, device="cpu")
    runner.fit("widget")
    runner.evaluate("widget")
    if method == "Depth":
        from cmdiad_tpu_torch.data.mvtec3d import MVTec3DDataset
        first = MVTec3DDataset(root, "widget", "train", SIZE, SIZE, SIZE).load(0)
        assert np.array_equal(seen[0][0].numpy(), first["depth3"])


def test_presets_build_configs_and_mtfi_is_refused(backbones):
    assert method_preset("rgb").method_name == "DINO"
    assert method_preset("xyz", f_coreset=0.5).f_coreset == 0.5
    assert method_preset("dual").method_name == "DINO+Point_MAE"
    with pytest.raises(KeyError):
        method_preset("nope")
    # the MTFI presets build (no longer refused): the method and its
    # fusion net, the FtoF MLP between the small backbones' widths
    from cmdiad_tpu_torch.methods.variants import HallucinationMethod
    from cmdiad_tpu_torch.models.hallucination import FtoFMlp
    cfg = method_preset("mtfi_ftof_xyz_main", rgb_size=SIZE)
    method = build_method(cfg, backbone=backbones[2])
    assert type(method) is HallucinationMethod and isinstance(method.fusion, FtoFMlp)
    assert method.fusion.xyz_norm.normalized_shape == (32,)
