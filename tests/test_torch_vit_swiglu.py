"""DINOv2 ViT-g/14 with four registers and the packed SwiGLU FFN in the port
(``models/vit.py``) and in the benchmark (``perfbench/``), on the CPU at
tiny widths with seeded random weights (the 1.14 B-parameter model is built
on the ``meta`` device only):

* the port's gated ``VisionTransformer`` with LayerScale and four registers
  on a true 37x37 grid against the plain reference
  ``perfbench/reference/vit_swiglu.py``, on the einsum and the fused path;
* the reference's FFN and the port's ``GluMlp`` against ``transformers``'
  ``Dinov2WithRegistersSwiGLUFFN``, which pins the half that takes the SiLU;
* the ``VIT_CONFIGS`` entry at its published widths and parameter count;
* the ``vit_swiglu`` model part's timm-named leaves loaded into a built
  ``DualBackbone`` (``convert.load_named``) against the same reference;
* ``perfbench/counts/vit_swiglu.py`` against a hand count;
* a tiny ``vit_swiglu`` configuration run as a whole cell: the program
  reads correct and its bfloat16 control does not, and a block that states
  the GELU FFN or another hidden width fails the shape check;
* the rgb readers on the new configuration.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

from cmdiad_tpu_torch.config import method_preset
from cmdiad_tpu_torch.methods.registry import build_backbone
from cmdiad_tpu_torch.models.vit import VIT_CONFIGS, GluMlp, ViTConfig, VisionTransformer

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.core import cell, spec, trace, weights as W  # noqa: E402
from perfbench.core.cell import LayerContext  # noqa: E402
from perfbench.model_parts import vit_swiglu as part  # noqa: E402
from perfbench.reference import vit_swiglu as reference  # noqa: E402

torch.set_num_threads(4)
CPU = torch.device("cpu")
PERFBENCH_DATA = REPO / "perfbench" / "tests" / "data"
GIANT = "vit_giant_patch14_reg4_dinov2.lvd142m"
# the 37x37 grid of 518² / 14 at a CPU size: 148² images, patch 4; fc1 192, fc2 96
GRID37 = dict(img_size=148, patch_size=4, embed_dim=64, depth=2, num_heads=2, mlp_ratio=4.0,
              qkv_bias=True, ln_eps=1e-6, layer_scale=True, num_reg_tokens=4, ffn="swiglu",
              mlp_hidden=96)
# both forwards are float32 from the same weights, summed in other orders
# (an einsum against q @ k^T, the fused path's plain version against the
# reference's softmax; the gate the same ops on the same halves) over two
# blocks: they agree to a few float32 ulps of the largest feature, far
# inside 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _images(n, side, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, side, side, 3, generator=g)


def _block(**kw):
    return {"source": "test", **GRID37, **kw}


def _seeded(net, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            # LayerScale and norm scales about 1, so that every branch counts
            one = name.endswith("gamma") or ("norm" in name and name.endswith("weight"))
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + (1.0 if one else 0.0))
    return net.eval()


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "fused"])
def test_port_gated_vit_on_a_37_grid_matches_the_reference(use_flash):
    c = ViTConfig(**GRID37)
    assert c.grid == 37
    net = _seeded(VisionTransformer(c, use_flash=use_flash), 19)
    sd = dict(net.state_dict())
    assert sd["blocks.0.mlp.fc1.weight"].shape == (192, 64)
    assert sd["blocks.1.mlp.fc2.weight"].shape == (64, 96)
    x = _images(2, 148, 3)
    with torch.no_grad():
        port = net(x).reshape(2, 37 * 37, 64)
    ref = reference.patches(sd, x, _block())
    torch.testing.assert_close(port, ref, **TOL)


def test_the_ffn_is_transformers_dinov2_swiglu(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    hf = pytest.importorskip(
        "transformers.models.dinov2_with_registers.modeling_dinov2_with_registers")
    # hidden_size 48 at DINOv2's mlp_ratio 4: (int(192 * 2/3) + 7) // 8 * 8 = 128
    theirs = hf.Dinov2WithRegistersSwiGLUFFN(
        hf.Dinov2WithRegistersConfig(hidden_size=48, mlp_ratio=4)).eval()
    assert theirs.weights_in.weight.shape == (256, 48)
    ours = _seeded(GluMlp(48, 128), 5)
    sd = {f"mlp.{k}": v for k, v in ours.state_dict().items()}
    with torch.no_grad():
        for mine, hers in (("fc1", theirs.weights_in), ("fc2", theirs.weights_out)):
            hers.weight.copy_(sd[f"mlp.{mine}.weight"])
            hers.bias.copy_(sd[f"mlp.{mine}.bias"])
        x = torch.randn(2, 12, 48, generator=torch.Generator().manual_seed(8))
        want, port = theirs(x), ours(x)
        ref = reference.ffn(sd, "mlp", x)
        # the same F.linear, chunk, silu and product on the same weights
        assert torch.equal(port, want) and torch.equal(ref, want)
        # the SiLU on the other half would differ: the test pins the half
        x1, x2 = torch.nn.functional.linear(x, theirs.weights_in.weight,
                                            theirs.weights_in.bias).chunk(2, -1)
        swapped = theirs.weights_out(torch.nn.functional.silu(x2) * x1)
        assert (swapped - want).abs().max() > 1e-3


def test_the_published_entry_at_its_widths_on_the_meta_device():
    c = VIT_CONFIGS[GIANT]
    with torch.device("meta"):
        net = VisionTransformer(c)
    assert len(net.blocks) == 40 and c.grid == 37 and c.embed_dim == 1536
    blk = net.blocks[0]
    assert isinstance(blk.mlp, GluMlp) and blk.attn.num_heads == 24
    assert blk.mlp.fc1.weight.shape == (8192, 1536) and blk.mlp.fc1.bias.shape == (8192,)
    assert blk.mlp.fc2.weight.shape == (1536, 4096) and blk.mlp.fc2.bias.shape == (1536,)
    assert net.pos_embed.shape[1] + 1 + net.reg_token.shape[1] == 1374
    assert sum(p.numel() for p in net.parameters()) == 1_136_483_840
    block = spec.load_config("dinov2g_reg4_pointmae")["vit_swiglu"]
    assert dataclasses.asdict(c) == {k: v for k, v in block.items() if k != "source"}
    # the part's leaves are the port's tensors, name and shape
    shapes = {n: s for n, s, *_ in part.leaves(block)}
    assert shapes == {n: tuple(p.shape) for n, p in net.state_dict().items()}


def test_part_leaves_load_through_timm_names_and_match_the_reference(monkeypatch):
    block = _block()
    monkeypatch.setitem(VIT_CONFIGS, "test_glu", ViTConfig(
        **{k: v for k, v in block.items() if k != "source"}))
    cfg = method_preset("rgb", rgb_backbone_name="test_glu", xyz_backbone_name="tiny",
                        rgb_size=148, xyz_size=64, gt_size=64, num_group=32, group_size=16)
    bb = build_backbone(cfg, "cpu")
    made = W.make("vit_swiglu", block, 2 ** 33 + 11, CPU, 0)
    assert "blocks.1.mlp.fc1.weight" in made.numpy
    assert set(made.numpy) == set(bb.vit.state_dict())
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
    block = 2 * t * d * 3 * d + 4 * t * t * d + 2 * t * d * d + 2 * t * d * 2 * h + 2 * t * h * d
    return 2 * n * 3 * p * p * d + depth * block


@pytest.mark.parametrize("which", ["published", "tiny"])
def test_count_matches_the_hand_count_over_every_token(which):
    count = spec.count("vit_swiglu")
    if which == "published":
        c = spec.load_config("dinov2g_reg4_pointmae")["vit_swiglu"]
        assert count.tokens(c) == 1 + 4 + 1369 == 1374
        t, d = 1374, 1536
        # the per-block table: qkv, scores and values, proj, fc1, fc2 (GFLOP)
        parts = (2 * t * d * 3 * d, 4 * t * t * d, 2 * t * d * d, 2 * t * d * 8192,
                 2 * t * 4096 * d)
        assert [round(x / 1e9, 2) for x in parts] == [19.45, 11.6, 6.48, 34.58, 17.29]
        hand = _hand_count(1369, 14, 1536, 40, 4096, 5)
        embed = 2 * 1369 * 588 * 1536
        assert hand == embed + 40 * sum(parts)
        # 3.112 TFLOP linear, 0.464 attention, 0.0025 embedding: 3.578 an image
        linear = 40 * (parts[0] + parts[2] + parts[3] + parts[4])
        assert (round(linear / 1e12, 3), round(40 * parts[1] / 1e12, 3),
                round(embed / 1e12, 4)) == (3.112, 0.464, 0.0025)
        assert hand == pytest.approx(3.578e12, rel=1e-3)
        # float32 at 67 TFLOP/s: 53.4 ms an image
        config = {"dtype": "float32", "vit_swiglu": c}
        assert count.least_s_per_image(config, {"of": "vit_swiglu"}) == pytest.approx(
            hand / 67e12) == pytest.approx(53.4e-3, rel=1e-3)
    else:
        c = _block()
        hand = _hand_count(37 * 37, 4, 64, 2, 96, 5)
    assert count.flops_per_image(c) == hand


def _tiny_config(directory, **block):
    """A tiny ``vit_swiglu`` + Point-MAE configuration in ``directory``: the
    image at 80 (10 x 10 patches of 8), the cloud at 64."""
    cfg = json.loads((PERFBENCH_DATA / "tiny_dual.json").read_text())
    cfg["models"] = cfg["program_models"] = ["vit_swiglu", "point_mae"]
    vit = cfg.pop("vit")
    cfg["vit_swiglu"] = {**vit, "img_size": 80, "layer_scale": True, "num_reg_tokens": 4,
                         "ffn": "swiglu", "mlp_hidden": 48, **block}
    cfg["rgb_size"] = cfg["overrides"]["rgb_size"] = 80
    cfg["overrides"]["rgb_backbone_name"] = "tiny_glu"
    cfg["banks"]["rgb"]["queries"] = 100
    cfg["step"][0] = {"part": "vit_swiglu", "of": "vit_swiglu"}
    (directory / "tiny_vit_swiglu.json").write_text(json.dumps(cfg))
    return spec.Cell(
        name="tiny_vit_swiglu", config=spec.load_config("tiny_vit_swiglu", directory),
        traffic=json.loads((PERFBENCH_DATA / "tiny_traffic.json").read_text()),
        limits=json.loads((PERFBENCH_DATA / "tiny_limits.json").read_text()),
        per_layer=[], end_to_end=spec.load_cell("dino_pointmae.b8").end_to_end)


@pytest.fixture
def tiny_glu(monkeypatch, tmp_path):
    """The port's 'tiny' ViT with LayerScale, four registers and the gated
    FFN (fc1 96, fc2 48), by name; the cell's state file in a directory of
    its own, so that no other test's cell run, in another process, writes
    or removes it meanwhile."""
    monkeypatch.setitem(VIT_CONFIGS, "tiny_glu", dataclasses.replace(
        VIT_CONFIGS["tiny"], layer_scale=True, num_reg_tokens=4, ffn="swiglu", mlp_hidden=48))
    monkeypatch.setattr(cell, "CACHE", tmp_path / "cache")


SEED = 2 ** 31 + 2207


def test_a_tiny_vit_swiglu_configuration_runs_as_a_whole_cell(tiny_glu, tmp_path):
    c = _tiny_config(tmp_path)
    r = cell.run(c, SEED, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    control = cell.run(c, SEED, 0.5, False, "cpu", overrides={"compute_dtype": "bfloat16"})
    assert not control["correct"]
    assert max(v["value"] / v["limit"] for v in control["checks"].values()) > 3


@pytest.mark.parametrize("block", [{"ffn": "gelu"}, {"mlp_hidden": 64}],
                         ids=["gelu", "hidden"])
def test_a_block_the_program_does_not_run_fails_the_shape_check(tiny_glu, tmp_path, block):
    with pytest.raises(ValueError, match="other sizes than the configuration"):
        cell.run(_tiny_config(tmp_path, **block), SEED, 0.5, False, "cpu")


@pytest.mark.parametrize("metric, spans, value", [
    ("vit_gate.device_ms", {"vit_gate": 0.004}, 0.5),
    ("vit_mlp.device_ms", {"vit_mlp": 0.24, "vit_gate": 0.004}, 30.0),
    # the hand count above over 0.08 s an image
    ("vit_roofline", {"rgb_patches": 0.64}, 100 * 3578443075584 / 67e12 / 0.08),
    ("vit_gate.device_ms", {"vit_mlp": 0.24}, None),
])
def test_readers_of_the_vit_metrics_on_the_giant(metric, spans, value):
    red = trace.Reduced(window_s=1.0, busy_s=0.9, span_device_s=spans, device_ops=[],
                        idle_gaps=[])
    ctx = LayerContext(red, {}, 8, spec.load_config("dinov2g_reg4_pointmae"), 0.09)
    got = spec.reader(metric).read(ctx)
    assert got == (None if value is None else pytest.approx(value, rel=1e-12))
