"""Data-parallel MTFI in the port: FtoF with the xyz main modality
(``WithHallucination``, ``use_hn``) and ``mesh_shape=(2,)`` on two gloo CPU
ranks, the JAX package's random fusion net bridged, against one device and
against the JAX package's ``mesh_shape=(2,)`` run, as
``test_torch_parallel_detect.py`` holds ``DINO+Point_MAE``, with depth-1
backbones (tolerances and why: ``torch_parallel_fixtures``).  The fusion net runs on each rank's
block, and the stats-only rgb bank's partials come from the gathered
batch."""

import numpy as np
import pytest
import torch

import jax
from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.methods import registry as jax_registry
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.parallel import launch

import torch_parallel_workers as workers
from torch_parallel_fixtures import (CFG, SAMPLES, SHALLOW_PM, SHALLOW_VIT, assert_metrics_close,
                                     assert_served_agree, jax_backbone,
                                     jax_bf16_selection, jax_predictions,  # noqa: F401
                                     spawn_beside)

torch.set_num_threads(2)

FTOF = dict(CFG, method_name="WithHallucination", main_modality="xyz", use_hn=True,
            mesh_shape=(2,), batch_size=3)
# fewer samples than the DINO+Point_MAE test (the JAX package's MTFI
# programs compile longer); batch 3 over 2 ranks pads every batch
FEW = dict(SAMPLES, n_train=4, n_test_good=2, n_test_bad=2)


@pytest.fixture(scope="module")
def runs(jax_bf16_selection, tmp_path_factory):  # noqa: F811
    jb, params = jax_backbone(SHALLOW_VIT, SHALLOW_PM)
    jcfg = JaxConfig(**FTOF)
    jnet, jvars = jax_registry.build_fusion(jcfg, jb)
    host_vars = jax.device_get(jvars)
    fusion_sd = names.to_torch(names.ftof_mlp(len(host_vars["params"]["xyz_mlp"])),
                               host_vars)
    own = spawn_beside(workers.detect, 2, "gloo", ["cpu"] * 2,
                       args=(FTOF, SHALLOW_VIT, SHALLOW_PM, params, FEW, fusion_sd))
    train, test = make_synthetic_samples(**FEW)
    jr = JaxRunner(jcfg, backbone=jb, params=params, fusion=jnet, fusion_vars=jvars)
    jr.fit("widget", train)
    jax_run = jax_predictions(jr.method, jr.evaluate("widget", test))
    state = str(tmp_path_factory.mktemp("mtfi_dp") / "jax_dp.npz")
    jr.method.save_state(state)
    ranks = own.result()
    served = launch.spawn(workers.serve, 2, "gloo", ["cpu"] * 2,
                          args=(FTOF, SHALLOW_VIT, SHALLOW_PM, params, FEW, state, fusion_sd))
    return jax_run, ranks, served


def test_dp_mtfi_matches_one_device(runs):
    _, ranks, _ = runs
    assert [res["mesh"] for res in ranks] == [((2,), 0), ((2,), 1)]
    # the main and fusion banks keep rows, the stats-only rgb bank none
    assert set(ranks[0]["bank_rows"]) == {"xyz", "fusion"}
    assert_metrics_close(ranks[0]["own"][0], ranks[0]["one"][0])


def test_dp_mtfi_serves_the_jax_dp_fit(runs):
    jax_run, _, served = runs
    for res in served:
        assert_served_agree(res, jax_run)


def test_dp_mtfi_ranks_compute_the_same_predictions(runs):
    _, (a, b), served = runs
    for x, y in ((a["own"], b["own"]), served):
        assert x[0] == y[0]
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[2], y[2])
