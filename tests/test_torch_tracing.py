"""The port's spans and counters (``cmdiad_tpu_torch/tracing.py``).

Both benchmark configurations' methods (``dual``, ``mtfi_ftof_xyz_main``)
serve a random fitted state; on the CPU at the tiny widths:

* with no profiler running, a ``predict_batch`` opens no profiler range and
  counts nothing;
* under ``torch.profiler`` every span of ``tracing.SPANS`` opens the
  expected number of times, inside ``predict``;
* on a warm call ``h2d_bytes`` is the parts' bytes and ``host_syncs`` the
  one readback (constants and fuser weights stay on the device, the parts
  go up without a host wait), ``const_uploads`` is 0, ``calls`` and
  ``images`` the batches and parts;
* each of the ViT's blocks opens ``vit_attention`` and ``vit_mlp`` once,
  only under the profiler, and Point-MAE's blocks open neither; the gated
  FFN opens ``vit_gate`` once a block inside ``vit_mlp``, and a GELU ViT,
  the ViT with registers and Point-MAE open none;
  ``vit_attn_score_bytes`` is B * H * N² * 4 a block on the einsum path and
  0 on the fused one;
* no span name is one that ``perfbench/spans.json`` wraps, and the
  benchmark's readers of the counters and of ``vit_gate`` read them (or
  nothing).

On a card (``cuda``, skipped without one), at the configurations' full
widths: ``host_syncs`` equals the synchronisations
``torch.cuda.set_sync_debug_mode("warn")`` reports over one warm call, and
both are 1, with no constant uploaded; the
call launches FPS and the KNN once each and the attention kernel once a
block of each backbone it runs, writing no scores, and the point path's
sub-spans hold 90-100 % of ``xyz_patches``' device time.
The file imports no JAX:

    python -m pytest -q -s --noconftest tests/test_torch_tracing.py
"""

import collections
import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from cmdiad_tpu_torch import kernels, tracing
from cmdiad_tpu_torch.config import method_preset
from cmdiad_tpu_torch.methods.registry import build_backbone, build_fusion, build_method
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig, PointTransformer, group_points
from cmdiad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from cmdiad_tpu_torch.ops.masked import host_compact_points
from cmdiad_tpu_torch.ops.scoring import bank_nn_table

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PRESETS = ("dual", "mtfi_ftof_xyz_main")      # the benchmark's two configurations
TINY = dict(rgb_backbone_name="tiny", xyz_backbone_name="tiny", rgb_size=64,
            xyz_size=64, gt_size=64, num_group=32, group_size=16)
XYZ_SPANS = ("fps", "knn", "group_encoder", "point_blocks", "regrid")
VIT_SPANS = ("vit_attention", "vit_mlp")
GATE = "vit_gate"
BATCH = 3


def _method(preset, device, rows, **overrides):
    """The preset's method serving a random fitted state of ``rows`` rows a
    scored bank (statistics (0, 1), unit fuser weights)."""
    cfg = method_preset(preset, **overrides)
    backbone = build_backbone(cfg, device)
    method = build_method(cfg, backbone=backbone, fusion=build_fusion(cfg, backbone, device))
    width = {"xyz": backbone.pm_config.out_dim, "rgb": backbone.vit_config.embed_dim,
             "fusion": backbone.vit_config.embed_dim}
    names = [m[0] for m in method._batch_modalities()]
    gen = torch.Generator().manual_seed(0)
    for n in names:
        bank = torch.randn(rows, width[n], generator=gen).to(method.device)
        method.banks[n], method.bank_sizes[n], method.stats[n] = bank, rows, (0.0, 1.0)
        method.nn_tables[n] = bank_nn_table(bank, k=cfg.n_reweight, n_valid=rows,
                                            metric=cfg.dist_method_s)
    for f in (method.detect_fuser, method.seg_fuser):
        f.load_weights(np.ones(len(names)), np.zeros(1))
    return method


def _batch(b, n, size, capacity, seed=0):
    """A stacked batch of ``b`` rows, ``n`` of them parts, half their grid
    points valid."""
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    pc[rng.random((b, size, size)) < 0.5] = 0.0
    return {"rgb": rng.normal(size=(b, size, size, 3)).astype(np.float32),
            "organized_pc": pc,
            "points_compact": np.stack([host_compact_points(p, capacity) for p in pc]),
            "gt": np.zeros((b, size, size), np.float32), "label": np.zeros(b, np.int64),
            "rgb_path": [f"part{i}.png" for i in range(b)], "_n": n}


@pytest.fixture(scope="module", params=PRESETS)
def tiny(request):
    method = _method(request.param, "cpu", 64, **TINY)
    method.predict_batch(_batch(BATCH, BATCH, 64, 2048))      # warm: constants on the device
    method.reset_predictions()
    return request.param, method


def _expected(preset, method, batch):
    """(host syncs, bytes uploaded) of one warm call, site by site: the
    parts go up without a host wait and the scores and maps come back in
    one copy; the constants and the fuser weights are already there."""
    keys = ("rgb", "organized_pc", "points_compact") if preset == "dual" else (
        "organized_pc", "points_compact")
    return 1, sum(batch[k].nbytes for k in keys)


def _vit_counts(preset, method, rows):
    """The ViT's counter over a call of ``rows`` batch rows: the float32
    (rows, H, N, N) scores of every block (none where the ViT is not run)."""
    if preset != "dual":
        return {}
    c = method.backbone.vit_config
    n = c.num_patches + 1 + c.num_reg_tokens
    return {"vit_attn_score_bytes": c.depth * rows * c.num_heads * n * n * 4}


def test_no_profiler_opens_no_range_and_counts_nothing(tiny, monkeypatch):
    _, method = tiny
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or pytest.fail("range opened"))
    before = tracing.counters()
    assert not tracing.enabled()
    method.predict_batch(_batch(BATCH, BATCH, 64, 2048))
    method.reset_predictions()
    assert opened == [] and tracing.counters() == before


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        fn()
    assert not tracing.enabled()
    return [e for e in prof.events() if e.name.startswith("span.")]


def test_spans_open_inside_predict(tiny):
    preset, method = tiny
    events = _profiled(lambda: method.predict_batch(_batch(BATCH, BATCH, 64, 2048)))
    method.reset_predictions()
    seen = collections.Counter(e.name[len("span."):] for e in events)
    depth = method.backbone.vit_config.depth if preset == "dual" else 0
    vit = dict.fromkeys(VIT_SPANS, depth) if depth else {}
    assert seen == {"predict": 1, "upload": 1, "readback": 1, **dict.fromkeys(XYZ_SPANS, 1),
                    **vit}
    (call,) = [e.time_range for e in events if e.name == "span.predict"]
    for e in events:
        assert call.start <= e.time_range.start <= e.time_range.end <= call.end, e.name


def test_counters_are_the_hand_sum_of_what_a_call_moves(tiny):
    preset, method = tiny
    full, tail = _batch(BATCH, BATCH, 64, 2048, seed=1), _batch(BATCH, 1, 64, 2048, seed=2)
    tracing.reset_counters()
    _profiled(lambda: method.predict_batch(full))
    syncs, nbytes = _expected(preset, method, full)
    vit = _vit_counts(preset, method, BATCH)
    assert tracing.counters() == {"calls": 1, "images": BATCH, "host_syncs": syncs,
                                  "h2d_bytes": nbytes, **vit}
    _profiled(lambda: method.predict_batch(tail))              # padded: 1 part of 3 rows
    assert tracing.counters() == {"calls": 2, "images": BATCH + 1, "host_syncs": 2 * syncs,
                                  "h2d_bytes": 2 * nbytes,
                                  **{k: 2 * v for k, v in vit.items()}}
    assert len(method.image_preds) == BATCH + 1
    method.reset_predictions()
    tracing.reset_counters()


def test_counting_stops_outside_a_predict_call():
    tracing.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tracing.to_device(np.zeros(4, np.float32), "cpu")
        tracing.count("host_syncs")
        with tracing.predict_call(2):
            tracing.to_device(np.zeros(4, np.float32), "cpu")
            tracing.to_host(torch.zeros(3))
        tracing.count("host_syncs")
    assert tracing.counters() == {"calls": 1, "images": 2, "host_syncs": 2, "h2d_bytes": 16}
    tracing.reset_counters()


def test_span_names_are_not_the_benchmarks_wrapped_names():
    wrapped = set(json.loads((REPO / "perfbench" / "spans.json").read_text()))
    assert len(set(tracing.SPANS)) == len(tracing.SPANS) == 11
    assert not wrapped & set(tracing.SPANS)


REG4 = ViTConfig(img_size=56, patch_size=8, embed_dim=32, depth=3, num_heads=2,
                layer_scale=True, num_reg_tokens=4)
GATED = dataclasses.replace(REG4, ffn="swiglu", mlp_hidden=48)


def _vit(use_flash=False, config=REG4):
    net = VisionTransformer(config, use_flash=use_flash)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return net.eval()


def test_vit_spans_open_once_a_block_and_only_under_the_profiler(monkeypatch):
    net, x = _vit(), torch.randn(2, 56, 56, 3)
    events = _profiled(lambda: net(x))
    blocks = collections.Counter(e.name[len("span."):] for e in events)
    assert blocks == dict.fromkeys(VIT_SPANS, REG4.depth)
    # in block order: attention, then MLP
    order = [e.name for e in sorted(events, key=lambda e: e.time_range.start)]
    assert order == ["span.vit_attention", "span.vit_mlp"] * REG4.depth
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: pytest.fail("range opened"))
    with torch.no_grad():
        net(x)


@pytest.mark.parametrize("config, gates", [
    (ViTConfig(img_size=56, embed_dim=32, depth=3, num_heads=2), 0), (REG4, 0),
    (GATED, GATED.depth)], ids=["gelu", "reg4", "gated"])
def test_vit_gate_opens_once_a_block_inside_vit_mlp_in_the_gated_vit(config, gates, monkeypatch):
    net, x = _vit(config=config), torch.randn(2, 56, 56, 3)
    with torch.no_grad():
        events = _profiled(lambda: net(x))
    seen = collections.Counter(e.name[len("span."):] for e in events)
    assert seen == {**dict.fromkeys(VIT_SPANS, config.depth), **({GATE: gates} if gates else {})}
    mlps = [e.time_range for e in events if e.name == "span.vit_mlp"]
    for e in events:
        if e.name == "span." + GATE:
            assert sum(m.start <= e.time_range.start <= e.time_range.end <= m.end
                       for m in mlps) == 1
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: pytest.fail("range opened"))
    with torch.no_grad():
        net(x)


def test_point_mae_blocks_open_no_vit_span():
    cfg = PointMAEConfig(num_group=16, group_size=8, encoder_dims=16, trans_dim=16, depth=3,
                         num_heads=2, fetch_idx=(0, 2))
    net = PointTransformer(cfg).eval()
    pts = torch.randn(2, 256, 3)
    centers, ori_idx, _ = group_points(pts, torch.ones(2, 256, dtype=torch.bool), 16, 8)
    with torch.no_grad():
        events = _profiled(lambda: net(pts, centers, ori_idx))
    names = collections.Counter(e.name for e in events)
    assert names["span.point_blocks"] == 1
    assert not {"span." + n for n in (*VIT_SPANS, GATE)} & set(names)


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "fused"])
def test_vit_attn_score_bytes_counts_the_einsum_scores(use_flash):
    net, b = _vit(use_flash), 3
    tracing.reset_counters()
    with torch.no_grad():
        net(torch.randn(b, 56, 56, 3))                         # no profiler: nothing
        _profiled(lambda: net(torch.randn(b, 56, 56, 3)))      # outside a predict: nothing
        assert "vit_attn_score_bytes" not in tracing.counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.predict_call(b):
                net(torch.randn(b, 56, 56, 3))
    n = 7 * 7 + 1 + 4
    assert tracing.counters()["vit_attn_score_bytes"] == (
        0 if use_flash else REG4.depth * b * REG4.num_heads * n * n * 4)
    tracing.reset_counters()


@pytest.mark.parametrize("metric, counts, value", [
    ("host_syncs_per_call", {"calls": 4, "host_syncs": 108}, 27.0),
    ("h2d_mb_per_image", {"images": 8, "h2d_bytes": 16_000_000}, 2.0),
    ("host_syncs_per_call", {}, None),
    ("h2d_mb_per_image", {}, None),
    # 16 heads x 1374² float32 scores x 24 blocks: 2899.6 MB an image
    ("vit_attn_score_mb_per_image", {"images": 8, "vit_attn_score_bytes": 8 * 16 * 1374 ** 2
                                     * 4 * 24}, 16 * 1374 ** 2 * 4 * 24 / 1e6),
    ("vit_attn_score_mb_per_image", {"images": 8, "vit_attn_score_bytes": 0}, 0.0),
    ("vit_attn_score_mb_per_image", {"images": 8}, None),
])
def test_benchmark_readers_of_the_counters(metric, counts, value, monkeypatch):
    from perfbench.core import spec
    monkeypatch.setattr(tracing, "_counts", dict(counts))
    assert spec.reader(metric).read(None) == value
    assert spec.reader(metric + ".b1").read(None) == value


@pytest.mark.parametrize("spans, images, value", [
    ({"vit_gate": 0.0125, "vit_mlp": 0.1}, 8, 1.5625),
    ({"vit_mlp": 0.1}, 8, None),
    ({"vit_gate": 0.0125}, 0, None),
])
def test_vit_gate_reader_on_a_reduced_trace(spans, images, value):
    from perfbench.core import spec, trace
    from perfbench.core.cell import LayerContext
    red = trace.Reduced(window_s=1.0, busy_s=0.9, span_device_s=spans, device_ops=[],
                        idle_gaps=[])
    ctx = LayerContext(red, {}, images, spec.load_config("dinov2g_reg4_pointmae"), 0.09)
    assert spec.reader("vit_gate.device_ms").read(ctx) == value


# ---------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
def test_card_syncs_and_span_split(preset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cmdiad_tpu_torch.device import resolve_device
    from perfbench.core import trace

    dev = resolve_device("cuda")
    method = _method(preset, dev, 8192)
    batch = _batch(8, 8, 224, 32768, seed=3)
    method.predict_batch(batch)                                # warm
    torch.cuda.synchronize()
    tracing.reset_counters()
    kernels.reset_launches()
    caught = []

    def call():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                method.predict_batch(batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        caught.extend(w)

    spans = trace.Spans({"xyz_patches": "cmdiad_tpu_torch.models.backbone.DualBackbone.xyz_patches"})
    spans.install()
    try:
        red = trace.reduce(trace.profile(call))
    finally:
        spans.remove()
    # set_sync_debug_mode's own notice is not a synchronisation
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and Path(w.filename) != Path(torch.cuda.__file__)]
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
    c = tracing.counters()
    xyz = red.span_device_s["xyz_patches"]
    sub = {n: red.span_device_s.get(n, 0.0) for n in XYZ_SPANS}
    print(json.dumps({"preset": preset, "counters": c, "sync_warnings": len(syncs),
                      "where": dict(where), "xyz_patches_ms": 1e3 * xyz,
                      "sub_ms": {n: 1e3 * v for n, v in sub.items()},
                      "sub_share": sum(sub.values()) / xyz}))
    assert c["calls"] == 1 and c["images"] == 8
    # float32 attention at head dim 64 takes the kernel in every block
    vit_depth = method.backbone.vit_config.depth if preset == "dual" else 0
    assert kernels.LAUNCHES["flash_attn"] == vit_depth + method.backbone.pm_config.depth
    assert c.get("vit_attn_score_bytes", 0) == 0 and ("vit_attn_score_bytes" in c) == (
        preset == "dual"), c
    assert c["host_syncs"] == len(syncs) == 1, where
    assert c.get("const_uploads", 0) == 0, c
    # the whole batch is grouped through one FPS and one KNN launch
    assert kernels.LAUNCHES["fps"] == kernels.LAUNCHES["knn"] == 1, kernels.LAUNCHES
    assert all(0.0 < v <= xyz for v in sub.values()), sub
    assert 0.9 * xyz <= sum(sub.values()) <= xyz * (1 + 1e-9), (sub, xyz)
