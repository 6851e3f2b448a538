"""Data-parallel detection in the port: ``DINO+Point_MAE`` with
``mesh_shape=(2,)`` on two gloo CPU ranks, against one device and against
the JAX package's ``mesh_shape=(2,)`` (tolerances and why:
``torch_parallel_fixtures``).

* each rank's own DP fit and evaluation against one device's fit and
  evaluation in the same process: metrics within the JAX package's DP
  tolerance 5e-3 (``tests/test_parallel.py``);
* the JAX package's DP fit, served by the two ranks data-parallel: its
  predictions and metrics;
* both ranks compute the same predictions and metrics.
"""

import numpy as np
import pytest
import torch

from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
from cmdiad_tpu_torch.parallel import launch

import torch_parallel_workers as workers
from torch_parallel_fixtures import (CFG, SAMPLES, SMALL_PM, SMALL_VIT, assert_metrics_close,
                                     assert_same_run, assert_served_agree, jax_backbone,
                                     jax_bf16_selection, jax_predictions,  # noqa: F401
                                     spawn_beside)

torch.set_num_threads(2)

DP = dict(CFG, method_name="DINO+Point_MAE", mesh_shape=(2,))


@pytest.fixture(scope="module")
def runs(jax_bf16_selection, tmp_path_factory):  # noqa: F811
    jb, params = jax_backbone()
    own = spawn_beside(workers.detect, 2, "gloo", ["cpu"] * 2,
                       args=(DP, SMALL_VIT, SMALL_PM, params, SAMPLES))
    train, test = make_synthetic_samples(**SAMPLES)
    jr = JaxRunner(JaxConfig(**DP), backbone=jb, params=params)
    jr.fit("widget", train)
    jax_run = jax_predictions(jr.method, jr.evaluate("widget", test))
    state = str(tmp_path_factory.mktemp("dp") / "jax_dp.npz")
    jr.method.save_state(state)
    ranks = own.result()
    served = launch.spawn(workers.serve, 2, "gloo", ["cpu"] * 2,
                          args=(DP, SMALL_VIT, SMALL_PM, params, SAMPLES, state))
    return jax_run, ranks, served


def test_dp_detection_matches_one_device(runs):
    _, ranks, _ = runs
    assert [res["mesh"] for res in ranks] == [((2,), 0), ((2,), 1)]
    assert_metrics_close(ranks[0]["own"][0], ranks[0]["one"][0])


def test_dp_detection_serves_the_jax_dp_fit(runs):
    jax_run, _, served = runs
    for res in served:
        assert_served_agree(res, jax_run)


def test_dp_ranks_compute_the_same_predictions(runs):
    _, (a, b), served = runs
    for x, y in ((a["own"], b["own"]), served):
        assert x[0] == y[0]
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[2], y[2])
    # one device's run is the same computation: the DP one may sum its
    # GEMMs over another batch size, within the JAX package's DP tolerances
    assert_same_run(a["own"], a["one"])
