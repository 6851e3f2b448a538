"""Checkpoints, DINOv2, Point-BERT, ``with_2828`` and the MTFI feature dumps:
the port against the JAX package, float32, the small backbones.

* DINOv2-style ViTs (LayerScale; LayerScale with four register tokens,
  whose ``pos_embed`` covers the patches only) and a Point-BERT
  (``encoder_dims`` != ``trans_dim``) with JAX parameters bridged across;
  features to 1e-5 of their largest value, as ``test_torch_models.py``;
* reference-named state dicts written with ``torch.save`` (the five fusion
  nets, a timm ViT, a ``base_model.``-prefixed Point-MAE, a Point-BERT
  pretraining checkpoint) load through both packages' ``build_fusion`` /
  ``load_backbone_params`` to the same outputs (1e-4 of the largest, as the
  net tests); the JAX package's ``save_pytree`` npz serves in the port; the
  port's ``convert-ckpt`` writes the JAX CLI's npz key for key, bit for bit;
* ``DoubleMethod`` with all three feature stores writes the JAX package's
  files, keys and shapes for both splits, arrays to 1e-4 of their largest;
* ``cli detect`` parses the MTFI and checkpoint fields and runs from
  ``.pth`` files.
"""

import argparse
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu import cli as jax_cli
from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.data.synthetic import _blob_pc
from cmdiad_tpu.methods import registry as jax_registry
from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
from cmdiad_tpu.models.hallucination import FtoFMlp as JaxFtoFMlp
from cmdiad_tpu.models.hrnet import HRNet as JaxHRNet
from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
from cmdiad_tpu.models.vit import ViTConfig as JaxViT
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu.train.checkpoint import save_pytree as jax_save_pytree
from cmdiad_tpu_torch import cli
from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
from cmdiad_tpu_torch.methods import registry
from cmdiad_tpu_torch.models.backbone import DualBackbone, init_weights, load_jax_params
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import ViTConfig
from cmdiad_tpu_torch.runner import CMDIADRunner

torch.set_num_threads(2)

SIZE = 64
SMALL_VIT = dict(img_size=SIZE, patch_size=8, embed_dim=32, depth=2, num_heads=2)
SMALL_PM = dict(num_group=32, group_size=16, encoder_dims=16, trans_dim=16,
                depth=2, num_heads=2, fetch_idx=(0, 1))
# DINOv2's patch 14 on a 5x5 grid: rgb_patch2 pools 5² *up* to 56²
DINOV2 = dict(img_size=70, patch_size=14, embed_dim=32, depth=2, num_heads=2,
              layer_scale=True)
POINT_BERT = dict(SMALL_PM, encoder_dims=24)
FLAGS = {"ftof_mlp": dict(method_name="WithHallucination", use_hn=True),
         "ftof_conv": dict(method_name="WithHallucination", use_hn_conv=True),
         "ftoi_mlp": dict(method_name="WithHallucinationFromFeature",
                          use_hn_from_rgb_mlp=True),
         "ftoi_conv": dict(method_name="WithHallucinationFromFeature",
                           use_hn_from_rgb_conv=True),
         "hrnet": dict(method_name="WithHallucination", use_hrnet=True)}


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _pair(vit=SMALL_VIT, pm=SMALL_PM, seed=0):
    jb = JaxBackbone(vit_config=JaxViT(**vit), pm_config=JaxPM(**pm),
                     use_pallas=False, image_size=vit["img_size"])
    params = jax.device_get(jb.init_params(seed))
    tb = DualBackbone(vit_config=ViTConfig(**vit), pm_config=PointMAEConfig(**pm),
                      device="cpu")
    return jb, params, tb


def _pcs(n=2, size=SIZE):
    return np.stack([_blob_pc(np.random.default_rng(i), size)[0] for i in range(n)])


@pytest.mark.parametrize("reg", [0, 4])
def test_dinov2_vit_matches_jax(rng, reg):
    vit = dict(DINOV2, num_reg_tokens=reg)
    jb, params, tb = _pair(vit=vit)
    # LayerScale's 1e-5 init would hide the blocks: give gamma real values
    for i in range(vit["depth"]):
        for k in ("ls1", "ls2"):
            params["vit"]["params"][f"blocks_{i}"][k] = rng.normal(
                size=vit["embed_dim"]).astype(np.float32)
    load_jax_params(tb, params)
    assert ("reg_token" in dict(tb.vit.named_parameters())) == bool(reg)
    assert tb.vit.pos_embed.shape[1] == 25 + (0 if reg else 1)
    img = rng.normal(size=(2, 70, 70, 3)).astype(np.float32)
    want = jb.rgb_patches(params, jnp.asarray(img))
    got = tb.rgb_patches(torch.from_numpy(img))
    assert got[0].shape == (2, 25, 32) and got[1].shape == (2, 3136, 32)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5)


def test_point_bert_matches_jax():
    jb, params, tb = _pair(pm=POINT_BERT)
    load_jax_params(tb, params)
    assert tb.point.reduce_dim.in_features == 24
    pcs = _pcs()
    want = jb.xyz_patches(params, jnp.asarray(pcs))
    got = tb.xyz_patches(torch.from_numpy(pcs))
    assert got["group_feats"].shape == (2, 32, 32)
    _close(got["group_feats"].numpy(), want["group_feats"], 1e-5)
    _close(got["xyz_patch"].numpy(), want["xyz_patch"], 1e-5)


def test_with_2828_matches_jax():
    jb, params, tb = _pair()
    load_jax_params(tb, params)
    pcs = _pcs()
    want = jb.xyz_patches(params, jnp.asarray(pcs), with_2828=True)
    got = tb.extract(organized_pc=torch.from_numpy(pcs), with_2828=True)
    assert got["xyz_patch_2828"].shape == (2, 784, 32)
    _close(got["xyz_patch_2828"].numpy(), want["xyz_patch_2828"], 1e-5)
    assert "xyz_patch_2828" not in tb.extract(organized_pc=torch.from_numpy(pcs))


def _reference_state_dict(module, seed):
    """A reference-layout state dict: the port's module names, random
    weights, BatchNorm statistics and affines."""
    init_weights(module, seed, fan_in_scaled=True)
    gen = torch.Generator().manual_seed(seed)
    sd = module.state_dict()
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen)
        elif k.endswith(("running_mean", "bias")) or (
                v.dim() == 1 and k.endswith("weight")):
            sd[k] = v + 0.1 * torch.randn(v.shape, generator=gen)
    return sd


def _fusion_outputs(kind, jax_net, jax_vars, port_net, rng):
    """Both nets' outputs on the same input (xyz main: xyz features, or the
    organized cloud for HRNet)."""
    if kind == "hrnet":
        x = rng.normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
        return port_net(torch.from_numpy(x)), jax_net.apply(jax_vars, jnp.asarray(x))
    x = rng.normal(size=(1, 3136, 32)).astype(np.float32)
    if kind.startswith("ftof"):
        return (port_net.generate(torch.from_numpy(x), "rgb"),
                jax_net.apply(jax_vars, jnp.asarray(x), "rgb", method="generate"))
    return port_net(torch.from_numpy(x)), jax_net.apply(jax_vars, jnp.asarray(x))


@pytest.fixture(scope="module")
def small():
    jb, params, tb = _pair()
    load_jax_params(tb, params)
    return jb, params, tb


@pytest.mark.parametrize("kind", list(FLAGS))
def test_reference_fusion_checkpoint_loads_in_both_packages(small, tmp_path, rng, kind):
    jb, _, tb = small
    kw = dict(main_modality="xyz", rgb_size=SIZE, xyz_size=SIZE, **FLAGS[kind])
    template = registry.build_fusion(Config(**kw), tb, "cpu")
    sd = _reference_state_dict(template, seed=3)
    if kind == "ftoi_conv":          # declared by the reference, never run
        sd = {**sd, "norm.weight": torch.ones(32), "norm.bias": torch.zeros(32)}
    path = str(tmp_path / "net.pth")
    torch.save({"model": sd}, path)
    port_net = registry.build_fusion(Config(**kw, fusion_module_path=path), tb, "cpu")
    jax_net, jax_vars = jax_registry.build_fusion(
        JaxConfig(**kw, fusion_module_path=path), jb)
    with torch.no_grad():
        got, want = _fusion_outputs(kind, jax_net, jax_vars, port_net, rng)
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("kind", ["ftof_mlp", "hrnet"])
def test_jax_npz_fusion_net_serves_in_the_port(small, tmp_path, rng, kind):
    """A net in the JAX package's ``save_pytree`` layout (as its training
    writes one) loads through ``fusion_module_path=*.npz``."""
    jb, _, tb = small
    net = JaxFtoFMlp(32, 32) if kind == "ftof_mlp" else JaxHRNet(32)
    args = ((jnp.zeros((1, 4, 32)), jnp.zeros((1, 4, 32))) if kind == "ftof_mlp"
            else (jnp.zeros((1, SIZE, SIZE, 3)),))
    variables = jax.device_get(net.init(jax.random.PRNGKey(5), *args))
    if kind == "hrnet":
        variables["batch_stats"] = jax.tree.map(
            lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
            variables["batch_stats"])
    path = str(tmp_path / "net.npz")
    jax_save_pytree(path, variables, meta={"epoch": 3})
    kw = dict(main_modality="xyz", rgb_size=SIZE, xyz_size=SIZE, **FLAGS[kind])
    port_net = registry.build_fusion(Config(**kw, fusion_module_path=path), tb, "cpu")
    from cmdiad_tpu_torch.train.checkpoint import load_meta
    assert load_meta(path) == {"epoch": 3}
    with torch.no_grad():
        got, want = _fusion_outputs(kind, net, variables, port_net, rng)
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("which", ["vit", "vit_dinov2_reg4", "point_mae", "point_bert"])
def test_reference_backbone_checkpoints_load_in_both_packages(tmp_path, rng, which):
    vit = dict(DINOV2, num_reg_tokens=4) if which == "vit_dinov2_reg4" else SMALL_VIT
    pm = POINT_BERT if which == "point_bert" else SMALL_PM
    jb, _, tb = _pair(vit=vit, pm=pm, seed=1)
    path = str(tmp_path / "backbone.pth")
    if which.startswith("vit"):
        sd = _reference_state_dict(tb.vit, seed=4)
        sd["head.weight"] = torch.zeros(10, vit["embed_dim"])     # not run
        torch.save({"model": sd}, path)
        kw = dict(rgb_ckpt_path=path)
    else:
        sd = _reference_state_dict(tb.point, seed=4)
        if which == "point_mae":
            sd = {f"base_model.{k}": v for k, v in sd.items()}
            sd["base_model.blocks.blocks.0.attn.qkv.bias"] = torch.ones(48)  # dropped
            torch.save(sd, path)
        else:
            sd = {f"module.transformer_q.{k}": v for k, v in sd.items()}
            sd["module.transformer_q.cls_head_finetune.0.weight"] = torch.ones(4, 4)
            sd["module.dvae.encoder.weight"] = torch.ones(4)
            torch.save({"base_model": sd}, path)
        kw = dict(xyz_ckpt_path=path,
                  xyz_backbone_name="Point_Bert" if which == "point_bert" else "Point_MAE")
    params = jax.device_get(jax_registry.load_backbone_params(JaxConfig(**kw), jb))
    registry.load_backbone_params(Config(**kw), tb)
    if which.startswith("vit"):
        img = rng.normal(size=(1, vit["img_size"], vit["img_size"], 3)).astype(np.float32)
        want = jb.rgb_patches(params, jnp.asarray(img))[0]
        got = tb.rgb_patches(torch.from_numpy(img))[0]
    else:
        pcs = _pcs(1)
        want = jb.xyz_patches(params, jnp.asarray(pcs))["group_feats"]
        got = tb.xyz_patches(torch.from_numpy(pcs))["group_feats"]
    _close(got.numpy(), want, 1e-4)


def test_missing_checkpoint_entry_raises(small, tmp_path):
    sd = dict(small[2].vit.state_dict())
    del sd["norm.weight"]
    path = str(tmp_path / "vit.pth")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="norm.weight"):
        registry.load_backbone_params(Config(rgb_ckpt_path=path), small[2])


@pytest.mark.parametrize("kind", ["vit", "point_mae", "ftof_mlp", "ftof_conv",
                                  "ftoi_mlp", "ftoi_conv", "hrnet"])
def test_convert_ckpt_writes_the_jax_cli_file(tmp_path, kind, capsys):
    """The converters read depth-12 backbones, so the backbone modules here
    are 12 blocks deep at tiny widths."""
    if kind == "vit":
        module = DualBackbone(vit_config=ViTConfig(img_size=16, embed_dim=8, depth=12,
                                                   num_heads=1), device="cpu").vit
    elif kind == "point_mae":
        module = DualBackbone(vit_config=ViTConfig(img_size=16, embed_dim=8, depth=1,
                                                   num_heads=1),
                              pm_config=PointMAEConfig(encoder_dims=8, trans_dim=8,
                                                       num_heads=1),
                              device="cpu").point
    else:
        _, _, tb = _pair()
        kw = dict(main_modality="xyz", rgb_size=SIZE, xyz_size=SIZE, **FLAGS[kind])
        module = registry.build_fusion(Config(**kw), tb, "cpu")
    sd = _reference_state_dict(module, seed=6)
    if kind == "point_mae":
        sd = {f"MAE_encoder.{k}": v for k, v in sd.items()}
    src = str(tmp_path / "src.pth")
    torch.save({"model": sd}, src)
    dst = {p: str(tmp_path / f"{p}.npz") for p in ("port", "jax")}
    cli.main(["convert-ckpt", "--src", src, "--dst", dst["port"], "--kind", kind])
    assert f"converted {src} -> {dst['port']}" in capsys.readouterr().out
    jax_cli.cmd_convert_ckpt(argparse.Namespace(src=src, dst=dst["jax"], kind=kind))
    with np.load(dst["port"]) as a, np.load(dst["jax"]) as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with np.load(path) as z:
                out[os.path.relpath(path, root)] = {k: z[k] for k in z.files}
    return out


def test_double_method_feature_dumps_match_jax(small, tmp_path):
    jb, params, tb = small
    train, test = make_synthetic_samples(n_train=3, n_test_good=1, n_test_bad=1,
                                         size=SIZE, seed=0)
    out = {}
    for tag in ("jax", "port"):
        d = tmp_path / tag
        kw = dict(rgb_size=SIZE, xyz_size=SIZE, gt_size=SIZE, f_coreset=0.5,
                  batch_size=2, save_feature_for_fusion=True, save_path=str(d / "fusion"),
                  save_frgb_xyz=True, save_path_frgb_xyz=str(d / "frgb_xyz"),
                  save_rgb_fxyz=True, save_path_rgb_fxyz=str(d / "rgb_fxyz"))
        if tag == "jax":
            runner = JaxRunner(JaxConfig(**kw), backbone=jb, params=params)
        else:
            runner = CMDIADRunner(Config(**kw), backbone=tb, device="cpu")
        runner.fit("widget", train)
        metrics = runner.evaluate("widget", test)
        assert all(np.isfinite(v) for v in metrics.values())
        out[tag] = _tree(d)
    names = sorted(out["jax"])
    assert sorted(out["port"]) == names and len(names) == 3 * 5
    assert {n for n in names if n.startswith("fusion/")} == {
        "fusion/train/widget0.npz", "fusion/train/widget1.npz",
        "fusion/train/widget2.npz", "fusion/test/widget3.npz", "fusion/test/widget4.npz"}
    shapes = {"patch": (3136, 64), "frgb": (3136, 32), "xyz": (SIZE, SIZE, 3),
              "hfxyz": (3136, 32), "lfxyz": (784, 32), "rgb": (SIZE, SIZE, 3)}
    for name in names:
        a, b = out["port"][name], out["jax"][name]
        assert sorted(a) == sorted(b), name
        for k in b:
            assert a[k].shape == b[k].shape == shapes[k] and a[k].dtype == b[k].dtype
            _close(a[k], b[k], 1e-4)
    # the training loader's view: the stores stack a split's samples
    from cmdiad_tpu.data.feature_store import FeatureStore as JaxStore
    from cmdiad_tpu_torch.data.feature_store import FeatureStore
    got = FeatureStore(str(tmp_path / "port" / "rgb_fxyz")).load_stacked(
        "train", ("hfxyz", "lfxyz", "rgb"))
    want = JaxStore(str(tmp_path / "jax" / "rgb_fxyz")).load_stacked(
        "train", ("hfxyz", "lfxyz", "rgb"))
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[0] == 3
        _close(got[k], want[k], 1e-4)


def test_cli_detect_runs_mtfi_from_checkpoint_files(tmp_path, monkeypatch):
    """``cli detect`` parses the MTFI and checkpoint fields and runs an
    FtoF xyz-main preset from a dataset on disk, the backbones and the
    fusion net loaded from reference-named ``.pth`` files that hold the
    weights of the CLI's own seed-7 build."""
    from cmdiad_tpu_torch.data.synthetic import make_synthetic_dataset
    root = make_synthetic_dataset(str(tmp_path / "mv"), n_train=3, n_test_good=1,
                                  n_test_bad=2, anomaly_radius=(0.13, 0.18))
    tiny = ["--rgb_backbone_name", "tiny", "--xyz_backbone_name", "tiny",
            "--rgb_size", "64", "--xyz_size", "64", "--gt_size", "64",
            "--num_group", "32", "--group_size", "16"]
    cfg = Config(rgb_backbone_name="tiny", xyz_backbone_name="tiny", rgb_size=64,
                 xyz_size=64, num_group=32, group_size=16, method_name="WithHallucination",
                 main_modality="xyz", use_hn=True, seed=7)
    src = registry.build_backbone(cfg, "cpu")
    net = registry.build_fusion(cfg, src, "cpu")
    paths = {k: str(tmp_path / f"{k}.pth") for k in ("vit", "point", "fusion")}
    torch.save({"model": src.vit.state_dict()}, paths["vit"])
    torch.save({f"base_model.{k}": v for k, v in src.point.state_dict().items()},
               paths["point"])
    torch.save({"model": net.state_dict()}, paths["fusion"])
    seen = []

    def spy(c, **kw):
        seen.append(registry.build_method(c, **kw))
        return seen[-1]

    monkeypatch.setattr("cmdiad_tpu_torch.runner.build_method", spy)
    results, _ = cli.main([
        "detect", "--device", "cpu", "--dataset_path", root, "--class_name", "widget",
        "--method_name", "WithHallucination", "--main_modality", "xyz",
        "--use_hn", "true", "--fusion_module_path", paths["fusion"],
        "--rgb_ckpt_path", paths["vit"], "--xyz_ckpt_path", paths["point"],
        "--f_coreset", "0.5", "--batch_size", "2", "--save_results", "false", *tiny])
    assert all(0.0 <= v <= 1.0 for v in results["widget"].values()), results
    method = seen[0]
    assert method.cfg.use_hn and method.cfg.main_modality == "xyz"
    for mine, theirs in ((method.fusion, net), (method.backbone.vit, src.vit),
                         (method.backbone.point, src.point)):
        for k, v in theirs.state_dict().items():
            assert torch.equal(mine.state_dict()[k], v), k
