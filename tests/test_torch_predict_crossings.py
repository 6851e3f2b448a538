"""What a predict call moves between host and device (``tracing.constant``,
``tracing.stage``, ``SGDOneClassSVM.device_coef``), on the CPU.

* Each constant the predict path keeps on the device (the pooling, resize
  and blur matrices, the quantized blur's divisor 255, the padding mask's
  far value) equals what its numpy function builds, bit for bit; the op that uses it
  leaves it in the memo, and a second request returns the same tensor with
  no upload.
* A part goes up with its layout, counting its bytes and no host sync.
* Successive ``predict_batch`` calls over different batches store the same
  predictions as a fresh method that builds and uploads every constant and
  fuser weight afresh, and a warm call uploads no constant.
* A refit through ``run_late_fusion`` and a ``load_state`` change the
  fused scores and maps exactly as the new ``coef_`` says: the fusers'
  device weights are never stale.

The file imports no JAX:

    python -m pytest -q --noconftest tests/test_torch_predict_crossings.py
"""

import numpy as np
import pytest
import torch

from cmdiad_tpu_torch import tracing
from cmdiad_tpu_torch.ops import blur, pooling, scoring
from test_torch_tracing import BATCH, PRESETS, TINY, _batch, _method

F32 = torch.float32
CONSTANTS = {   # op over fresh shapes -> the key (dtype, build, args) it keeps
    "adaptive": (lambda: pooling.adaptive_avg_pool(torch.ones(2, 37, 31, 3), (13, 11)),
                 [(F32, pooling._adaptive_avg_matrix, (37, 13)),
                  (F32, pooling._adaptive_avg_matrix, (31, 11))]),
    "bilinear": (lambda: pooling.bilinear_resize(torch.ones(1, 29, 23, 2), (61, 47)),
                 [(F32, pooling._bilinear_matrix, (29, 61)),
                  (F32, pooling._bilinear_matrix, (23, 47))]),
    "pool3x3": (lambda: pooling.avg3x3_then_adaptive_pool(torch.ones(1, 41, 43, 2), 11),
                [(F32, pooling._pool3x3_adaptive_matrix, (41, 11)),
                 (F32, pooling._pool3x3_adaptive_matrix, (43, 11))]),
    "blur": (lambda: blur.pil_gaussian_blur(torch.ones(2, 47, 53)),
             [(F32, blur._blur_matrix, (47, 4.0)), (F32, blur._blur_matrix, (53, 4.0))]),
    "quantized_blur_255": (lambda: blur.quantized_knn_gaussian_blur(torch.rand(2, 19, 19)),
                           [(F32, float, (255.0,))]),
    "padding_far": (lambda: scoring.mask_padding_cols(torch.zeros(3, 8), 5),
                    [(None, float, (scoring._FAR,))]),
}


@pytest.fixture
def uploads(monkeypatch):
    """The arrays ``tracing.to_device`` uploads from here on."""
    seen, real = [], tracing.to_device

    def record(x, device, dtype=None):
        seen.append(x)
        return real(x, device, dtype)

    monkeypatch.setattr(tracing, "to_device", record)
    return seen


@pytest.mark.parametrize("name", list(CONSTANTS))
def test_constants_equal_what_their_functions_build_and_upload_once(name, uploads):
    op, keys = CONSTANTS[name]
    op()
    del uploads[:]
    for dtype, build, args in keys:
        got = tracing.constant("cpu", dtype, build, *args)
        want = np.asarray(build(*args), np.float32)
        assert got.dtype == F32 and got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
        assert tracing.constant(torch.device("cpu"), dtype, build, *args) is got
    assert uploads == [], name                 # the op left each one in the memo
    op()
    assert uploads == [], name


def _parents_path(method, monkeypatch):
    """Every constant and fuser weight built and uploaded at each use."""
    monkeypatch.setattr(tracing, "constant", lambda device, dtype, build, *args:
                        tracing.to_device(build(*args), device, dtype))
    monkeypatch.setattr(method, "_fuser_weights", lambda: tuple(
        tracing.to_device(np.asarray(f.coef_).reshape(-1), method.device, F32)
        for f in (method.detect_fuser, method.seg_fuser)))


def _profiled_counters(fn):
    tracing.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    c = tracing.counters()
    tracing.reset_counters()
    return c


def test_stage_keeps_a_parts_layout_and_counts_bytes_not_syncs():
    """A planar image (as a resize leaves it) goes up with its strides, as
    the blocking upload left them; in a predict call it counts its bytes and
    no host sync."""
    rgb = np.random.default_rng(0).normal(size=(2, 3, 9, 7)).astype(np.float32)
    rgb = rgb.transpose(0, 2, 3, 1)
    assert not rgb.flags["C_CONTIGUOUS"]
    got = []

    def call():
        with tracing.predict_call(2):
            got.append(tracing.stage(rgb, "cpu"))

    c = _profiled_counters(call)
    want = torch.as_tensor(rgb, device="cpu")
    assert got[0].stride() == want.stride() and torch.equal(got[0], want)
    assert c == {"calls": 1, "images": 2, "host_syncs": 0, "h2d_bytes": rgb.nbytes}


@pytest.mark.parametrize("preset", PRESETS)
def test_successive_calls_match_a_fresh_method(preset, monkeypatch):
    first, second = _batch(BATCH, BATCH, 64, 2048, seed=5), _batch(BATCH, 2, 64, 2048, seed=6)
    method = _method(preset, "cpu", 64, **TINY)
    method.predict_batch(first)
    c = _profiled_counters(lambda: method.predict_batch(second))
    assert c["host_syncs"] == 1 and c.get("const_uploads", 0) == 0, c
    fresh = _method(preset, "cpu", 64, **TINY)
    _parents_path(fresh, monkeypatch)
    fresh.predict_batch(first)
    fresh.predict_batch(second)
    assert len(method.image_preds) == BATCH + 2
    assert method.image_preds == fresh.image_preds
    for got, want in zip(method.predictions, fresh.predictions):
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)


def test_refit_and_load_state_change_the_fused_scores_as_coef_says(tmp_path):
    method = _method("dual", "cpu", 64, **TINY)
    batch = _batch(BATCH, BATCH, 64, 2048, seed=7)
    seen, record = [], method._record_predictions

    def capture(s_vec, maps, b):
        seen.append((s_vec.clone(), maps.clone()))
        record(s_vec, maps, b)

    method._record_predictions = capture

    def fused():
        """Predict ``batch``; check the stored answers against coef_ as it
        now is, and return them."""
        method.reset_predictions()
        seen.clear()
        method.predict_batch(batch)
        ((s_vec, maps),) = seen
        wd, ws = (torch.as_tensor(np.asarray(f.coef_).reshape(-1), dtype=F32)
                  for f in (method.detect_fuser, method.seg_fuser))
        s = (s_vec @ wd).numpy()
        m = torch.einsum("bkxy,k->bxy", maps, ws).numpy()
        assert method.image_preds == [float(v) for v in s]
        for got, want in zip(method.predictions, m):
            assert np.array_equal(got, want.astype(np.float64))
        return list(method.image_preds), [p.copy() for p in method.predictions]

    def refit(seed):
        method.add_batch_to_late_fusion_mem_bank(_batch(BATCH, BATCH, 64, 2048, seed=seed))
        method.run_late_fusion()
        return [np.asarray(f.coef_).copy() for f in (method.detect_fuser, method.seg_fuser)]

    unit = fused()
    coef_a = refit(8)
    assert not all(np.array_equal(c, np.ones_like(c)) for c in coef_a)
    after_a = fused()
    assert after_a[0] != unit[0]
    path = str(tmp_path / "state.npz")
    method.save_state(path)
    coef_b = refit(9)
    assert not all(np.array_equal(a, b) for a, b in zip(coef_a, coef_b))
    after_b = fused()
    assert after_b[0] != after_a[0]
    method.load_state(path)
    assert all(np.array_equal(np.asarray(f.coef_), c)
               for f, c in zip((method.detect_fuser, method.seg_fuser), coef_a))
    reloaded = fused()
    assert reloaded[0] == after_a[0]
    assert all(np.array_equal(x, y) for x, y in zip(reloaded[1], after_a[1]))
