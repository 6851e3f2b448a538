"""Row-sharded banks in the port: ``Point_MAE`` with ``shard_bank=True``
on two gloo CPU ranks (tolerances and why: ``torch_parallel_fixtures``).

* every rank's sharded fit and evaluation against one device's (the
  replicated bank) in the same process, at the JAX package's tolerances
  (``tests/test_parallel.py``).  Each shard chooses its row through the
  bf16 product and the exact distances of the shards' rows decide, so a
  near tie across shards could pick another row than the whole bank's
  choice, a map difference inside the bf16 envelope; this data has none
  (``test_torch_parallel.py`` holds the per-shard choice to the JAX
  package's);
* the JAX package's ``Config(mesh_shape=(2,), shard_bank=True)`` fit (l2,
  its bf16 kernel on each shard), served by the two ranks' sharded banks;
* the state round trip: rank 0 writes the sharded fit's file, a fresh
  method on each rank loads it, shards it again (4096 of the 8192 padded
  rows a rank) and scores identically; one device loads the same file
  whole.
"""

import os

import numpy as np
import pytest
import torch

from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.runner import CMDIADRunner as JaxRunner
from cmdiad_tpu_torch.config import Config
from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
from cmdiad_tpu_torch.methods.registry import build_method
from cmdiad_tpu_torch.parallel import launch

import torch_parallel_workers as workers
from torch_parallel_fixtures import (CFG, SAMPLES, SMALL_PM, SMALL_VIT, assert_same_run,
                                     assert_served_agree, jax_backbone,
                                     jax_bf16_selection, jax_predictions,  # noqa: F401
                                     spawn_beside)

torch.set_num_threads(2)

SHARD = dict(CFG, method_name="Point_MAE", shard_bank=True)


@pytest.fixture(scope="module")
def runs(jax_bf16_selection, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("shard")
    jb, params = jax_backbone()
    saved = str(tmp / "port_sharded.npz")
    own = spawn_beside(workers.detect, 2, "gloo", ["cpu"] * 2,
                       args=(SHARD, SMALL_VIT, SMALL_PM, params, SAMPLES, None, saved))
    train, test = make_synthetic_samples(**SAMPLES)
    jr = JaxRunner(JaxConfig(**SHARD, mesh_shape=(2,)), backbone=jb, params=params)
    jr.fit("widget", train)
    jax_run = jax_predictions(jr.method, jr.evaluate("widget", test))
    state = str(tmp / "jax_sharded.npz")
    jr.method.save_state(state)
    ranks = own.result()
    served = launch.spawn(workers.serve, 2, "gloo", ["cpu"] * 2,
                          args=(SHARD, SMALL_VIT, SMALL_PM, params, SAMPLES, state))
    return jax_run, ranks, served, saved, jb, params


def test_sharded_bank_matches_the_replicated_bank(runs):
    _, ranks, _, _, _, _ = runs
    assert [res["mesh"] for res in ranks] == [((2,), 0), ((2,), 1)]
    for res in ranks:
        assert res["bank_rows"]["xyz"][0] == 4096
        assert_same_run(res["own"], ranks[0]["one"])


def test_sharded_bank_serves_the_jax_sharded_fit(runs):
    jax_run, _, served, _, _, _ = runs
    for res in served:
        assert_served_agree(res, jax_run)
    np.testing.assert_array_equal(served[0][1], served[1][1])


def test_sharded_state_round_trip(runs):
    _, ranks, _, saved, _, _ = runs
    for res in ranks:
        assert res["reloaded"][0] == res["own"][0]
        np.testing.assert_array_equal(res["reloaded"][1], res["own"][1])
        np.testing.assert_array_equal(res["reloaded"][2], res["own"][2])
    assert sorted(os.listdir(os.path.dirname(saved))) == ["jax_sharded.npz",
                                                          "port_sharded.npz"]
    # one device reads the whole bank back
    from cmdiad_tpu_torch.models.backbone import DualBackbone, load_jax_params
    from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
    from cmdiad_tpu_torch.models.vit import ViTConfig
    bb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT), pm_config=PointMAEConfig(**SMALL_PM),
                      device="cpu")
    load_jax_params(bb, runs[5])
    method = build_method(Config(**SHARD), backbone=bb)
    method.load_state(saved)
    assert method.bank_mesh is None and method.banks["xyz"].shape[0] == 8192
