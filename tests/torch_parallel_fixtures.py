"""Shared set-up of the port's multi-device detection tests
(``test_torch_parallel_detect.py``, ``_mtfi.py``, ``_shard.py``): the JAX
package fits on its virtual mesh in the test process, the port's ranks are
spawned with gloo on the CPU (``torch_parallel_workers.detect``).

Tolerances: the JAX package's own for a data-parallel or sharded run
against one device (``tests/test_parallel.py``): metrics 5e-3, image scores
rtol 1e-4, maps rtol 1e-3 / atol 1e-4.  A port run serving a JAX fit is
held to the JAX run as ``test_torch_slice.py`` holds two packages serving
one state: image scores rtol 1e-5, maps within the bf16 near-tie envelope
(max 1e-2, mean 1e-4 of the map maximum).  Here the port's own fit is
held to the JAX package's only through served state; one device's own fits
are compared in ``test_torch_detect.py``.
"""

import concurrent.futures

import numpy as np
import pytest

import jax
import cmdiad_tpu.methods.base as jax_base
import cmdiad_tpu.ops.scoring as jax_scoring
import cmdiad_tpu.parallel.eval as jax_parallel_eval
from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
from cmdiad_tpu.models.vit import ViTConfig as JaxViT

SIZE = 64
SMALL_VIT = dict(img_size=SIZE, patch_size=8, embed_dim=32, depth=2, num_heads=2)
SMALL_PM = dict(num_group=32, group_size=16, encoder_dims=16, trans_dim=16,
                depth=2, num_heads=2, fetch_idx=(0, 1))
# the MTFI runs' depth-1 backbones, as tests/test_parallel.py's
SHALLOW_VIT = dict(SMALL_VIT, depth=1)
SHALLOW_PM = dict(SMALL_PM, depth=1, fetch_idx=(0,))
SAMPLES = dict(n_train=5, n_test_good=3, n_test_bad=3, size=SIZE, seed=0,
               anomaly_radius=(0.13, 0.18))
# batch 4 over 2 ranks: the tails (5 = 4 + 1, 6 = 4 + 2) exercise the padding
CFG = dict(rgb_size=SIZE, xyz_size=SIZE, gt_size=SIZE, f_coreset=0.1, max_sample=10,
           batch_size=4)
METRICS = ("image_rocauc", "pixel_rocauc", "au_pro", "au_pro_001")
DP_METRIC_TOL = 5e-3


def _clear_jax_programs():
    jax.clear_caches()
    for mod in (jax_base, jax_parallel_eval):
        for fn in vars(mod).values():
            if hasattr(fn, "cache_clear"):
                fn.cache_clear()


@pytest.fixture(scope="module")
def jax_bf16_selection():
    """The JAX package's l2 scoring through its bf16 bank-min kernel
    (interpreted), also on each shard of a sharded bank."""
    gate = lambda rows, metric: metric in ("l2", "l2_int8") and rows % 1024 == 0  # noqa: E731
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_scoring, "use_scoring_kernel", gate)
    mp.setattr(jax_parallel_eval, "_use_scoring_kernel", gate)
    _clear_jax_programs()
    yield
    mp.undo()
    _clear_jax_programs()


def jax_backbone(vit=SMALL_VIT, pm=SMALL_PM):
    jb = JaxBackbone(vit_config=JaxViT(**vit), pm_config=JaxPM(**pm),
                     use_pallas=False, image_size=SIZE)
    return jb, jax.device_get(jb.init_params(0))


def jax_predictions(method, metrics):
    return metrics, np.asarray(method.image_preds), np.stack(method.predictions)


def assert_metrics_close(a, b, tol=DP_METRIC_TOL):
    for k in METRICS:
        assert abs(a[k] - b[k]) <= tol, (k, a, b)


def assert_served_agree(got, want):
    """Two packages serving one fitted state (``test_torch_slice.py``)."""
    (mg, sg, pg), (mw, sw, pw) = got, want
    np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-7)
    scale = float(np.abs(pw).max())
    diff = np.abs(pg - pw)
    assert diff.max() <= 1e-2 * scale, diff.max() / scale
    assert diff.mean() <= 1e-4 * scale, diff.mean() / scale
    assert_metrics_close(mg, mw)


def assert_same_run(got, want):
    """A multi-device run against one device: the JAX package's DP
    tolerances."""
    (mg, sg, pg), (mw, sw, pw) = got, want
    np.testing.assert_allclose(sg, sw, rtol=1e-4)
    np.testing.assert_allclose(pg, pw, rtol=1e-3, atol=1e-4)
    assert_metrics_close(mg, mw)


def spawn_beside(*args, **kw):
    """``parallel.launch.spawn(*args, **kw)`` on a thread, so that the JAX
    package can fit in this process meanwhile; returns its future."""
    from cmdiad_tpu_torch.parallel import launch
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.spawn, *args, **kw)
    pool.shutdown(wait=False)
    return future
