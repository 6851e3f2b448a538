"""DINOv2 ViT-L/14 with four registers in the port (``models/vit.py``) and
in the benchmark (``perfbench/``), on the CPU at tiny widths with seeded
random weights:

* the port's ``VisionTransformer`` with LayerScale and four registers on a
  true 37x37 grid (148² images, patch 4) against the plain reference
  ``perfbench/reference/vit_reg.py``, on the einsum and the fused path;
* the ``vit_reg`` model part's timm-named leaves loaded into a built
  ``DualBackbone`` (``convert.load_named``) against the same reference;
* ``perfbench/counts/vit_reg.py`` against a hand count over every token,
  the cls token and the registers included;
* a tiny ``vit_reg`` configuration run as a whole cell (the look for a card
  skipped): the program reads correct and its bfloat16 control does not,
  and a block that states other registers or no LayerScale fails the shape
  check;
* the readers of the ViT's per-layer metrics on a reduced trace.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

from cmdiad_tpu_torch.config import method_preset
from cmdiad_tpu_torch.methods.registry import build_backbone
from cmdiad_tpu_torch.models.vit import VIT_CONFIGS, ViTConfig, VisionTransformer

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.core import cell, spec, trace, weights as W  # noqa: E402
from perfbench.core.cell import LayerContext  # noqa: E402
from perfbench.model_parts import vit_reg as part  # noqa: E402
from perfbench.reference import vit_reg as reference  # noqa: E402

torch.set_num_threads(4)
CPU = torch.device("cpu")
PERFBENCH_DATA = REPO / "perfbench" / "tests" / "data"
# the 37x37 grid of 518² / 14 at a CPU size: 148² images, patch 4
GRID37 = dict(img_size=148, patch_size=4, embed_dim=64, depth=2, num_heads=2, mlp_ratio=4.0,
              qkv_bias=True, ln_eps=1e-6, layer_scale=True, num_reg_tokens=4)
# both forwards are float32 from the same weights, summed in other orders
# (an einsum against q @ k^T, the fused path's plain version against the
# reference's softmax) over two blocks: they agree to a few float32 ulps of
# the largest feature, far inside 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _images(n, side, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, side, side, 3, generator=g)


def _block(**kw):
    return {"source": "test", **GRID37, **kw}


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "fused"])
def test_port_vit_on_a_37_grid_matches_the_reference(use_flash):
    c = ViTConfig(**GRID37)
    assert c.grid == 37
    net = VisionTransformer(c, use_flash=use_flash)
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for name, p in net.named_parameters():
            # LayerScale and norm scales about 1, so that every branch counts
            one = name.endswith("gamma") or ("norm" in name and name.endswith("weight"))
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + (1.0 if one else 0.0))
    sd = dict(net.state_dict())
    assert sd["pos_embed"].shape == (1, 37 * 37, 64) and sd["reg_token"].shape == (1, 4, 64)
    assert "blocks.1.ls2.gamma" in sd
    x = _images(2, 148, 3)
    with torch.no_grad():
        port = net(x).reshape(2, 37 * 37, 64)
    ref = reference.patches(sd, x, _block())
    torch.testing.assert_close(port, ref, **TOL)


@pytest.mark.parametrize("regs", [4, 1])
def test_part_leaves_load_through_timm_names_and_match_the_reference(regs, monkeypatch):
    block = _block(num_reg_tokens=regs)
    monkeypatch.setitem(VIT_CONFIGS, "test_reg", ViTConfig(
        **{k: v for k, v in block.items() if k != "source"}))
    cfg = method_preset("rgb", rgb_backbone_name="test_reg", xyz_backbone_name="tiny",
                        rgb_size=148, xyz_size=64, gt_size=64, num_group=32, group_size=16)
    bb = build_backbone(cfg, "cpu")
    made = W.make("vit_reg", block, 2 ** 33 + 9, CPU, 0)
    # the part names every tensor of the port's ViT, as timm names it
    assert [n for n, *_ in part.leaves(block)] and set(made.numpy) == set(bb.vit.state_dict())
    part.load(bb, None, made.numpy)
    widths = part.widths(bb, None)
    assert all(widths[k] == v for k, v in block.items() if k not in part.NOT_WIDTHS)
    x = _images(2, 148, 5)
    port, pooled = bb.rgb_patches(x)
    assert port.shape == (2, 1369, 64) and pooled.shape == (2, 3136, 64)
    ref = part.features(made.on(CPU), {"rgb": x}, block)
    torch.testing.assert_close(port, ref, **TOL)


def _hand_count(n, p, d, depth, h, prefix):
    t = n + prefix
    block = 2 * t * d * 3 * d + 4 * t * t * d + 2 * t * d * d + 4 * t * d * h
    return 2 * n * 3 * p * p * d + depth * block


@pytest.mark.parametrize("which", ["published", "tiny"])
def test_count_matches_the_hand_count_over_every_token(which):
    count = spec.count("vit_reg")
    if which == "published":
        c = spec.load_config("dinov2l_reg4_pointmae")["vit_reg"]
        assert count.tokens(c) == 1 + 4 + 1369 == 1374
        t, d = 1374, 1024
        # the per-block table: qkv, scores and values, proj, MLP (GFLOP)
        parts = (2 * t * d * 3 * d, 4 * t * t * d, 2 * t * d * d, 4 * t * d * 4096)
        assert [round(x / 1e9, 2) for x in parts] == [8.64, 7.73, 2.88, 23.05]
        hand = _hand_count(1369, 14, 1024, 24, 4096, 5)
        assert hand == 2 * 1369 * 588 * 1024 + 24 * sum(parts)
        assert hand == pytest.approx(1.017e12, rel=1e-3)
        # float32 at 67 TFLOP/s: 15.2 ms an image
        config = {"dtype": "float32", "vit_reg": c}
        assert count.least_s_per_image(config, {"of": "vit_reg"}) == pytest.approx(
            hand / 67e12) == pytest.approx(15.17e-3, rel=1e-3)
    else:
        c = _block()
        hand = _hand_count(37 * 37, 4, 64, 2, 256, 5)
    assert count.flops_per_image(c) == hand


def _tiny_config(directory, **block):
    """A tiny ``vit_reg`` + Point-MAE configuration in ``directory``: the
    image at 80 (10 x 10 patches of 8), the cloud at 64."""
    cfg = json.loads((PERFBENCH_DATA / "tiny_dual.json").read_text())
    cfg["models"] = cfg["program_models"] = ["vit_reg", "point_mae"]
    vit = cfg.pop("vit")
    cfg["vit_reg"] = {**vit, "img_size": 80, "layer_scale": True, "num_reg_tokens": 4, **block}
    cfg["rgb_size"] = cfg["overrides"]["rgb_size"] = 80
    cfg["overrides"]["rgb_backbone_name"] = "tiny_reg4"
    cfg["banks"]["rgb"]["queries"] = 100
    cfg["step"][0] = {"part": "vit_reg", "of": "vit_reg"}
    (directory / "tiny_vit_reg.json").write_text(json.dumps(cfg))
    return spec.Cell(
        name="tiny_vit_reg", config=spec.load_config("tiny_vit_reg", directory),
        traffic=json.loads((PERFBENCH_DATA / "tiny_traffic.json").read_text()),
        limits=json.loads((PERFBENCH_DATA / "tiny_limits.json").read_text()),
        per_layer=[], end_to_end=spec.load_cell("dino_pointmae.b8").end_to_end)


@pytest.fixture
def tiny_reg4(monkeypatch):
    """The port's 'tiny' ViT with LayerScale and four registers, by name."""
    monkeypatch.setitem(VIT_CONFIGS, "tiny_reg4", dataclasses.replace(
        VIT_CONFIGS["tiny"], layer_scale=True, num_reg_tokens=4))


SEED = 2 ** 31 + 1723


def test_a_tiny_vit_reg_configuration_runs_as_a_whole_cell(tiny_reg4, tmp_path):
    c = _tiny_config(tmp_path)
    assert c.config["rgb_size"] != c.traffic["size"]
    r = cell.run(c, SEED, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    control = cell.run(c, SEED, 0.5, False, "cpu", overrides={"compute_dtype": "bfloat16"})
    assert not control["correct"]
    assert max(v["value"] / v["limit"] for v in control["checks"].values()) > 3


@pytest.mark.parametrize("block", [{"num_reg_tokens": 2}, {"layer_scale": False}],
                         ids=["registers", "layer_scale"])
def test_a_block_the_program_does_not_run_fails_the_shape_check(tiny_reg4, tmp_path, block):
    with pytest.raises(ValueError, match="other sizes than the configuration"):
        cell.run(_tiny_config(tmp_path, **block), SEED, 0.5, False, "cpu")


@pytest.mark.parametrize("config, metric, spans, value", [
    ("dinov2l_reg4_pointmae", "vit_attention.device_ms", {"vit_attention": 0.04}, 5.0),
    ("dinov2l_reg4_pointmae", "vit_mlp.device_ms", {"vit_mlp": 0.12}, 15.0),
    # the hand counts above over 0.02 and 0.004 s an image
    ("dinov2l_reg4_pointmae", "vit_roofline", {"rgb_patches": 0.16},
     100 * 1017102557184 / 67e12 / 0.02),
    ("dino_pointmae", "vit_roofline", {"rgb_patches": 0.032},
     100 * 156295139328 / 67e12 / 0.004),
    ("ftof_xyz_main", "vit_roofline", {"xyz_patches": 0.05}, None),
    ("dinov2l_reg4_pointmae", "vit_attention.device_ms", {}, None),
])
def test_readers_of_the_vit_metrics(config, metric, spans, value):
    red = trace.Reduced(window_s=1.0, busy_s=0.9, span_device_s=spans, device_ops=[],
                        idle_gaps=[])
    ctx = LayerContext(red, {}, 8, spec.load_config(config), 0.03)
    got = spec.reader(metric).read(ctx)
    assert got == (None if value is None else pytest.approx(value, rel=1e-12))


def test_the_published_config_is_the_configurations_vit_reg_block():
    c = VIT_CONFIGS["vit_large_patch14_reg4_dinov2.lvd142m"]
    block = spec.load_config("dinov2l_reg4_pointmae")["vit_reg"]
    # the block names no FFN: the entry runs the GELU MLP at 4 x 1024
    assert dataclasses.asdict(c) == {"ffn": "gelu", "mlp_hidden": 0, **{
        k: v for k, v in block.items() if k != "source"}}
    assert c.num_patches == 1369 and c.grid == 37
