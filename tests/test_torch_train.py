"""MTFI distillation training: the port's trainer against the JAX package's.

Both trainers start from the JAX trainer's own initial weights: its
``{"params", "batch_stats"}`` written with the JAX package's
``save_pytree`` (``meta={"epoch": -1}``) and given to the port as
``resume=`` (the real resume path).
The JAX trainers run on one device (``mesh_shape=(1,)``); the port on the
CPU.  Inputs are made with numpy from a seed.  Tolerances, fixed before the
first run:

* one training step (``check_step``): loss rtol 1e-5; each gradient leaf
  max|Δ| <= 1e-4 * max|g_jax| + 1e-7; the BatchNorm statistics after the
  step max|Δ| <= 1e-5 * max|leaf| (float32 summation order); bfloat16
  compute: loss rtol 2e-2.  The convolutional nets compare their
  gradients in float64 in both packages instead, at the same 1e-4 (HRNet's
  step; FtoFConv's BatchNorm conv stack and ``FtoIConv.loss`` at a smaller
  size, since the JAX package's float64 convolutions on the CPU would take
  minutes at full size), their losses and BatchNorm statistics in float32
  as above: float32 keeps few digits of some of their gradients in either
  package (a BatchNorm bias followed by ReLU, a conv and another BatchNorm
  has a gradient that cancels down to border effects; ReLUs on random
  convolutions flip).  HRNet's first step lies 0.5-3e-2 of a leaf's
  largest from its float64 gradient in the JAX package and in the port
  alike, FtoFConv's up to 3e-2, FtoIConv's 1e-3;
* the optimizer alone, the same six gradients: parameters and every state
  leaf max|Δ| <= 1e-6 * max|leaf|;
* whole runs (``test_torch_train_runs.py``): each epoch's train and test
  loss rtol 1e-4, final parameters max|Δ| <= 1e-3 * max|p| a leaf (Adam's
  normalised steps carry the gradients' float32 differences into the
  parameters at lr scale).

The convolutional nets' steps have files of their own, so that the test
workers spread them: ``test_torch_train_hrnet.py``,
``test_torch_train_ftof_conv.py`` and ``test_torch_train_ftoi_conv.py``
(FtoFConv and FtoIConv are 768 wide by construction).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cmdiad_tpu.config import TRAIN_METHODS as JAX_TRAIN_METHODS
from cmdiad_tpu.config import TrainConfig as JaxTrainConfig
from cmdiad_tpu.train.checkpoint import _flatten as jax_flatten
from cmdiad_tpu.train.checkpoint import save_pytree as jax_save_pytree
from cmdiad_tpu.train.distill import DistillTrainer as JaxTrainer
from cmdiad_tpu_torch.config import TRAIN_METHODS, TrainConfig
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.train.checkpoint import flatten, load_pytree
from cmdiad_tpu_torch.train.distill import DistillTrainer

torch.set_num_threads(2)

FTOF = "HallucinationCrossModality"
W = 16     # FtoFMlp width
BASE = dict(epochs=3, batch_size=4, warmup_epochs=1, blr=0.02, seed=0,
            output_dir="", save_every=100)


def _leaf_close(got, want, rel, name="", floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want)
    limit = rel * float(np.abs(want).max()) + floor
    if err.size and err.max() > limit:
        at = np.unravel_index(int(err.argmax()), err.shape)
        raise AssertionError(f"{name}: max|Δ| {err.max():.3e} > {limit:.3e} at {at} "
                             f"(got {got[at]!r}, want {want[at]!r})")


def ftof_arrays(rng, n, width=W, rgb_width=None, tokens=3136):
    """Correlated xyz | rgb patch features, so there is something to distil."""
    base = rng.normal(size=(n, tokens, width)).astype(np.float32)
    xyz = base + 0.05 * rng.normal(size=base.shape).astype(np.float32)
    rgb = 0.5 * base if rgb_width is None else rng.normal(size=(n, tokens, rgb_width))
    return {"patch": np.concatenate([xyz, rgb.astype(np.float32)], axis=2)}


def pair(tmp_path, kw, feature_dim, arrays, test_arrays=None, jax_kw=None):
    """(JAX trainer, port trainer): the port resumes from the JAX trainer's
    initial weights, written to ``tmp_path/init.npz``."""
    test_arrays = arrays if test_arrays is None else test_arrays
    jt = JaxTrainer(JaxTrainConfig(**{**kw, **(jax_kw or {}), "mesh_shape": (1,)}),
                    feature_dim, arrays=arrays, test_arrays=test_arrays)
    path = str(tmp_path / "init.npz")
    jax_save_pytree(path, {"params": jax.device_get(jt.params),
                           "batch_stats": jax.device_get(jt.batch_stats)},
                    meta={"epoch": -1})
    pt = DistillTrainer(TrainConfig(**kw, resume=path), feature_dim, arrays=arrays,
                        test_arrays=test_arrays, device="cpu")
    assert pt.start_epoch == jt.start_epoch == 0
    return jt, pt


def _float64_grads(jt, pt, init_path, batch):
    """The same step's gradients in float64 in both packages: the JAX net
    cloned to float64 (x64 switched on for the call) and the port's net
    from the initial file, every layer and the loss in float64 (HRNet)."""
    b64 = {k: v.astype(np.float64) for k, v in batch.items()}
    net = jt.net.clone(dtype=jnp.float64)
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),  # noqa: E731
                                            jax.device_get(t))
    stats = to64(jt.batch_stats)

    def lf(p):
        loss, _ = net.apply({"params": p, "batch_stats": stats}, b64["image"], b64["feature"],
                            True, method="loss", mutable=["batch_stats"])
        return loss
    jax.config.update("jax_enable_x64", True)
    try:
        want = jax.device_get(jax.grad(lf)(to64(jt.params)))
    finally:
        jax.config.update("jax_enable_x64", False)

    port = copy.deepcopy(pt.net)
    tree = load_pytree(init_path)
    port.load_state_dict(names.to_torch(pt.table, {k: tree[k] for k in ("params", "batch_stats")}))
    port.double()
    port.dtype = torch.float64
    loss, _ = pt.loss_fn(port, {k: torch.from_numpy(v) for k, v in b64.items()}, True)
    ps = dict(port.named_parameters())
    got = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    return got, names.to_torch(pt.table, {"params": want})


def check_step(tmp_path, kw, feature_dim, arrays, n=2, loss_rtol=1e-5, grads="float32"):
    """One training step's loss, gradients and BatchNorm statistics, the
    port's against ``jax.value_and_grad`` of the JAX trainer's ``loss_fn``;
    ``grads`` 'float64' compares the gradients in float64 instead, None
    not at all."""
    jt, pt = pair(tmp_path, kw, feature_dim, arrays)
    batch = {k: v[:n] for k, v in arrays.items()}

    def lf(p):
        return jt.loss_fn(jt._variables(p, jt.batch_stats),
                          {k: jnp.asarray(v) for k, v in batch.items()}, True)
    if grads == "float32":
        (loss_j, aux_j), grads_j = jax.value_and_grad(lf, has_aux=True)(jt.params)
    else:
        loss_j, aux_j = lf(jt.params)
    loss_p, aux_p, grads_p = pt.loss_and_grads(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=loss_rtol)
    for k in ("loss_xyz", "loss_rgb"):
        if k in aux_j:
            np.testing.assert_allclose(float(aux_p[k]), float(aux_j[k]), rtol=loss_rtol)
    if "batch_stats" in aux_j:
        got = flatten(names.to_flax(pt.table, pt.net.state_dict())["batch_stats"])
        want = jax_flatten(jax.device_get(aux_j["batch_stats"]))
        assert set(got) == set(want) and got
        for k in want:
            _leaf_close(got[k], want[k], 1e-5, k)
    if grads is None:
        return
    if grads == "float64":
        grads_p, want = _float64_grads(jt, pt, str(tmp_path / "init.npz"), batch)
    else:
        want = names.to_torch(pt.table, {"params": jax.device_get(grads_j)})
    assert set(want) == set(grads_p)
    for k, g in grads_p.items():
        _leaf_close(g.numpy(), want[k].numpy(), 1e-4, k, floor=1e-7)


def test_train_config_matches_the_jax_package():
    import dataclasses
    assert TRAIN_METHODS == JAX_TRAIN_METHODS
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours == theirs
    assert TrainConfig().replace(epochs=3).epochs == 3


@pytest.mark.parametrize("dist_method", ["cos_dist", "l2", "smooth_l1"])
def test_ftof_mlp_step(tmp_path, rng, dist_method):
    check_step(tmp_path, dict(BASE, train_method=FTOF, dist_method=dist_method), W,
               ftof_arrays(rng, 2))


def test_ftof_mlp_step_dino_small_split(tmp_path, rng):
    """``rgb_backbone='dino_small'``: the rgb half of the patch is 384 wide."""
    check_step(tmp_path, dict(BASE, train_method=FTOF, rgb_backbone="dino_small",
                              mlp_depth=2), W, ftof_arrays(rng, 2, rgb_width=384, tokens=196))


def test_ftof_mlp_step_bfloat16(tmp_path, rng):
    check_step(tmp_path, dict(BASE, train_method=FTOF, compute_dtype="bfloat16"), W,
               ftof_arrays(rng, 2), loss_rtol=2e-2, grads=None)


def _ftoi_arrays(rng, n, dim):
    return {"feature": rng.normal(size=(n, 3136, dim)).astype(np.float32),
            "target": rng.normal(size=(n, 224, 224, 3)).astype(np.float32)}


@pytest.mark.parametrize("tm,depth", [("RGBFeatureToXYZInputMLP", False),
                                      ("XYZFeatureToRGBInputMLP", False),
                                      ("RGBFeatureToXYZInputMLP", True)])
def test_ftoi_mlp_step(tmp_path, rng, tm, depth):
    """``estimate_depth``: a 1-channel net whose output broadcasts against
    the 3-channel target, as in the JAX package."""
    check_step(tmp_path, dict(BASE, train_method=tm, estimate_depth=depth), 32,
               _ftoi_arrays(rng, 2, 32))


@pytest.mark.parametrize("wd,accum", [(0.0, 1), (0.01, 1), (0.0, 2), (0.01, 3)])
def test_optimizer_matches_optax(tmp_path, rng, wd, accum):
    """The same six gradients through the JAX trainer's ``tx`` and the
    port's ``Adam``: with ``accum_iter=3`` and 16 samples at batch 4 an epoch
    is 4 micro-steps, so the second update accumulates across an epoch end."""
    kw = dict(BASE, train_method=FTOF, weight_decay=wd, accum_iter=accum)
    jt, pt = pair(tmp_path, kw, W, ftof_arrays(rng, 16, tokens=4))
    params, state = jt.params, jt.opt_state
    for _ in range(6):
        g = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), jax.device_get(params))
        updates, state = jt.tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        pt.opt.step({k: torch.from_numpy(v.numpy())
                     for k, v in names.to_torch(pt.table, {"params": g}).items()})
    want = jax_flatten({"params": jax.device_get(params),
                        "opt_state": jax.device_get(state)})
    tree = pt.state_tree()
    got = flatten({"params": tree["params"], "opt_state": tree["opt_state"]})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        _leaf_close(got[k], want[k], 1e-6, k)
