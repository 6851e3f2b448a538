"""The trace reduction on a hand-made chrome trace: device time by span
through the launch's correlation (runtime and driver launches), busy time,
idle gaps by host activity; and the readers on it."""

import pytest

from perfbench.core import spec, trace
from perfbench.core.cell import LayerContext


def _trace():
    ev = lambda cat, name, ts, dur, tid=1, **args: {
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}
    return {"traceEvents": [
        ev("user_annotation", trace.WINDOW, 0, 1000),
        ev("user_annotation", "span.score_patch_batch", 100, 300),
        ev("user_annotation", "span.bank_min", 150, 100),
        ev("cpu_op", "aten::mm", 110, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 112, 5, correlation=1),
        ev("cuda_driver", "cuLaunchKernelEx", 160, 5, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 500, 5, correlation=3),
        ev("kernel", "gemm", 200, 100, tid=7, correlation=1),
        ev("kernel", "bank_min_kernel", 300, 200, tid=7, correlation=2),
        ev("kernel", "copy", 600, 100, tid=7, correlation=3),
        ev("kernel", "orphan", 800, 50, tid=7, correlation=99),
        ev("cpu_op", "aten::copy_", 700, 120),
    ]}


def test_reduce_attributes_kernels_to_spans_and_finds_gaps():
    r = trace.reduce(_trace())
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s == pytest.approx(450e-6)
    assert r.span_device_s == pytest.approx({"score_patch_batch": 300e-6, "bank_min": 200e-6})
    assert r.unattributed_s == pytest.approx(50e-6)
    assert r.device_ops[0] == ("bank_min_kernel", pytest.approx(200e-6))
    gaps = dict(r.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(100e-6)             # 700 to 800
    assert gaps["cudaLaunchKernel"] == pytest.approx(100e-6)        # 500 to 600
    assert gaps["host outside any op"] == pytest.approx(350e-6)     # 0 to 200, 850 to 1000
    assert sum(gaps.values()) == pytest.approx(550e-6)


def test_readers_on_the_reduced_trace():
    r = trace.reduce(_trace())
    cfg = spec.load_config("dino_pointmae")
    ctx = LayerContext(r, {"bank_min": [((64, 768), (8192, 768))]}, 2, cfg, 0.02)
    assert spec.reader("scoring.device_ms").read(ctx) == pytest.approx(0.15)
    assert spec.reader("vit.device_ms").read(ctx) is None
    assert spec.reader("device_idle_pct").read(ctx) == pytest.approx(55.0)
    share = spec.reader("bank_min_roofline").read(ctx)
    least = spec.count("bank_min").least_s(64, 8192, 768)
    assert share == pytest.approx(100 * least / 200e-6)
    mfu = spec.reader("step_mfu_pct").read(ctx)
    assert 0 < mfu < 100
