"""Data-parallel distillation training in the port: ``TrainConfig(mesh_shape=
(2,))`` on two gloo CPU ranks, global batch 8 (2 x 4), one epoch of two
steps, for the FtoF MLP and for HRNet (the BatchNorm net, 32² inputs, an
8² grid of 16-wide features), every run starting from the JAX trainer's
initial weights (``resume=``, as ``test_torch_train.py``).

Tolerances, ``test_torch_train.py``'s (fixed there before its first run):

* against one device (the port's trainer on the whole batch, this
  process): the float64 parameters after the epoch to 1e-8 of a leaf's
  largest value for HRNet, and to 1e-4 for the MLP, whose LayerNorm
  computes in float32 in a float64 net (the card-vs-CPU limit of
  ``chip_smoke.py``'s training check).  HRNet's limit was first 1e-10 and
  the run read 4.4e-10: the ranks sum their blocks in another order, some
  BatchNorm-bias gradients cancel down to border effects (so float64 keeps
  fewer of their digits), and Adam's normalised first step moves a
  parameter by up to lr times its gradient's relative error; the float32
  first step's loss to rtol 1e-5 and gradients (HRNet's in float64) to
  1e-4 of a leaf's largest + 1e-7, the MLP's float32 epoch losses to rtol
  1e-4, both nets' float64 ones to the float64 parameters' tolerance;
* against the JAX package's ``DistillTrainer(TrainConfig(mesh_shape=
  (2,)))``: the first step's loss, aux losses and BatchNorm statistics
  (float32, rtol 1e-5 / 1e-5 of a leaf's largest), its gradients (the
  MLP's in float32, HRNet's in float64: float32 keeps about two digits of
  a conv net's gradients in either package) to 1e-4 + 1e-7; the MLP's
  epoch losses to rtol 1e-4 and float32 parameters to 1e-3 of a leaf's
  largest (Adam's normalised step carries the gradients' float32
  differences at lr scale).  HRNet's float32 epoch goes no further: its
  float32 gradients, two digits good, move the second step's loss by
  about 3e-4 in either package, and the float64 run is held to one device;
* HRNet with its BatchNorm moments taken over each rank's block alone
  misses the one-device parameters by more than 1e-6 of a leaf's largest:
  only the global moments pass;
* rank 0 alone writes ``checkpoint-0.npz`` and ``metrics.jsonl`` (one
  line an epoch), and ``resume='auto'`` finds the checkpoint on every rank.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu.config import TrainConfig as JaxTrainConfig
from cmdiad_tpu.train.checkpoint import _flatten as jax_flatten
from cmdiad_tpu.train.checkpoint import save_pytree as jax_save_pytree
from cmdiad_tpu.train.distill import DistillTrainer as JaxTrainer
from cmdiad_tpu_torch.config import TrainConfig
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.train.distill import DistillTrainer

import torch_parallel_workers as workers
from test_torch_train import BASE, _leaf_close, ftof_arrays
from torch_parallel_fixtures import spawn_beside

torch.set_num_threads(2)

KW = dict(BASE, epochs=1, batch_size=8, warmup_epochs=0)
NETS = {
    "ftof": dict(train_method="HallucinationCrossModality"),
    "hrnet": dict(train_method="RGBInputToXYZFeatureHRNET"),
}
# float64 parameters against one device, a share of a leaf's largest value
PARAMS64_RTOL = {"ftof": 1e-4, "hrnet": 1e-8}
W = 16
SEP = "\x1f"     # the checkpoints' key separator


def _arrays(net, rng, n):
    if net == "ftof":
        return ftof_arrays(rng, n, tokens=16)
    return {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            "feature": rng.normal(size=(n, 64, W)).astype(np.float32)}


def _jax_grads64(jt, batch):
    """The JAX net's gradients of ``batch`` in float64 (x64 switched on for
    the call), HRNet's loss as ``test_torch_train._float64_grads``."""
    b64 = {k: v.astype(np.float64) for k, v in batch.items()}
    net = jt.net.clone(dtype=jnp.float64)
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),  # noqa: E731
                                            jax.device_get(t))

    def lf(p):
        loss, _ = net.apply({"params": p, "batch_stats": to64(jt.batch_stats)}, b64["image"],
                            b64["feature"], True, method="loss", mutable=["batch_stats"])
        return loss
    jax.config.update("jax_enable_x64", True)
    try:
        return jax.device_get(jax.grad(lf)(to64(jt.params)))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    cache = {}

    def get(net):
        if net in cache:
            return cache[net]
        tmp = tmp_path_factory.mktemp(net)
        kw = dict(KW, **NETS[net])
        arrays, test_arrays = _arrays(net, rng, 16), _arrays(net, rng, 6)
        jt = JaxTrainer(JaxTrainConfig(**kw, mesh_shape=(2,)), W, arrays=arrays,
                        test_arrays=test_arrays)
        init = str(tmp / "init.npz")
        jax_save_pytree(init, {"params": jax.device_get(jt.params),
                               "batch_stats": jax.device_get(jt.batch_stats)},
                        meta={"epoch": -1})
        kw = dict(kw, resume=init)
        ranks = spawn_beside(workers.train, 2, "gloo", ["cpu"] * 2,
                             args=(dict(kw, mesh_shape=(2,)), W, arrays, test_arrays,
                                   str(tmp / "run")))

        # the first global batch, as every trainer draws it
        idx = np.random.default_rng(kw["seed"]).permutation(16)[:8]
        batch = {k: v[idx] for k, v in arrays.items()}

        def lf(p):
            return jt.loss_fn(jt._variables(p, jt.batch_stats),
                              {k: jnp.asarray(v) for k, v in batch.items()}, True)
        (loss, aux), grads = jax.value_and_grad(lf, has_aux=True)(jt.params)
        pt = DistillTrainer(TrainConfig(**kw), W, arrays=arrays, test_arrays=test_arrays,
                            device="cpu")
        jax_step = dict(
            loss=float(loss), aux={k: float(v) for k, v in aux.items() if k != "batch_stats"},
            grads=names.to_torch(pt.table, {"params": jax.device_get(grads)}),
            stats=jax_flatten(jax.device_get(aux.get("batch_stats", {}))),
            grads64=(names.to_torch(pt.table, {"params": _jax_grads64(jt, batch)})
                     if net == "hrnet" else None))
        jres = jt.train()
        jax_run = dict(history=jres.history,
                       params=jax_flatten(jax.device_get({"params": jres.params})))

        # one device: the port's trainer on the whole batch
        one_step = workers.first_step(copy.deepcopy(pt))
        one = pt.train()
        t64 = DistillTrainer(TrainConfig(**kw), W, test_arrays=test_arrays, device="cpu",
                             arrays={k: v.astype(np.float64) for k, v in arrays.items()})
        workers.to_float64(t64)
        grads64 = workers.first_step(copy.deepcopy(t64))[2]
        history64 = t64.train().history
        one_run = dict(step=one_step, grads64=grads64, history=one.history, history64=history64,
                       params64={k: np.asarray(v) for k, v in workers._flat_state(t64).items()})
        cache[net] = (jax_step, jax_run, one_run, ranks.result())
        return cache[net]
    return get


def _params_close(got, want, rel):
    keys = [k for k in want if k.startswith("params")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        _leaf_close(got[k], want[k], rel, k)


@pytest.mark.parametrize("net", list(NETS))
def test_dp_training_matches_one_device(runs, net):
    _, _, one, ranks = runs(net)
    for res in ranks:
        loss, aux, grads, _ = res["step32"]
        np.testing.assert_allclose(loss, one["step"][0], rtol=1e-5)
        got, want = ((res["grads64"], one["grads64"]) if net == "hrnet"
                     else (grads, one["step"][2]))
        for k, g in got.items():
            _leaf_close(g, want[k], 1e-4, k, floor=1e-7)
        for k in ("train_loss", "test_loss"):
            if net == "ftof":     # HRNet's float32 epoch: see the docstring
                np.testing.assert_allclose(res["history"][k], one["history"][k], rtol=1e-4)
            np.testing.assert_allclose(res["history_params64"][k], one["history64"][k],
                                       rtol=PARAMS64_RTOL[net])
        _params_close(res["params64"], one["params64"], PARAMS64_RTOL[net])
    for k, v in ranks[0]["params64"].items():      # the ranks hold one replica
        np.testing.assert_array_equal(v, ranks[1]["params64"][k])


@pytest.mark.parametrize("net", list(NETS))
def test_dp_training_matches_jax_dp(runs, net):
    jstep, jrun, _, ranks = runs(net)
    for res in ranks:
        loss, aux, grads, stats = res["step32"]
        np.testing.assert_allclose(loss, jstep["loss"], rtol=1e-5)
        for k, v in jstep["aux"].items():
            np.testing.assert_allclose(aux[k], v, rtol=1e-5)
        assert set(stats) == {f"batch_stats{SEP}{k}" for k in jstep["stats"]}
        for k, v in jstep["stats"].items():
            _leaf_close(stats[f"batch_stats{SEP}{k}"], v, 1e-5, k)
        got, want = ((res["grads64"], jstep["grads64"]) if net == "hrnet"
                     else (grads, jstep["grads"]))
        for k, g in got.items():
            _leaf_close(g, want[k].numpy(), 1e-4, k, floor=1e-7)
        if net == "ftof":
            for k in ("train_loss", "test_loss"):
                np.testing.assert_allclose(res["history"][k], jrun["history"][k], rtol=1e-4)
            _params_close(res["params32"], jrun["params"], 1e-3)


def test_local_batch_norm_moments_would_fail(runs):
    _, _, one, ranks = runs("hrnet")
    with pytest.raises(AssertionError):
        _params_close(ranks[0]["params64_local_bn"], one["params64"], 1e-6)


def test_dp_training_writes_from_rank_0_and_resumes_everywhere(runs):
    _, _, _, ranks = runs("ftof")
    assert ranks[0]["files"] == ["checkpoint-0.npz", "metrics.jsonl"]
    assert [res["resumed_at"] for res in ranks] == [1, 1]
