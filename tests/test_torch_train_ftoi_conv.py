"""FtoIConv (feature-to-input conv) training, the port's against the JAX
trainer's.

* one step of both FtoI conv train methods at 768-wide features on the 56²
  grid, 224² targets, batch 1: the loss in float32 (tolerances:
  ``test_torch_train.py``);
* the gradients of ``FtoIConv.loss`` in float64 in both packages at 1e-4 of
  a leaf's largest, 3 and 1 (``estimate_depth``) output channels, 32-wide
  features, 64² output: float32 keeps about three digits of conv1's and
  conv2's gradients here (the port's float32 gradient lies 8e-4 and 1.1e-3
  of the leaf's largest from its float64 one at the full-width step), and
  the JAX package's float64 convolutions on the CPU would take minutes at
  full width.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu.models.hallucination import FtoIConv as JaxFtoIConv
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.models.hallucination import FtoIConv
from test_torch_train import BASE, _leaf_close, check_step

torch.set_num_threads(2)


@pytest.mark.parametrize("tm", ["RGBFeatureToXYZInputConv", "XYZFeatureToRGBInputConv"])
def test_ftoi_conv_step(tmp_path, rng, tm):
    arrays = {"feature": rng.normal(size=(1, 3136, 768)).astype(np.float32),
              "target": rng.normal(size=(1, 224, 224, 3)).astype(np.float32)}
    check_step(tmp_path, dict(BASE, train_method=tm), 768, arrays, n=1, grads=None)


@pytest.mark.parametrize("out_channels", [3, 1])
def test_ftoi_conv_gradients_in_float64(rng, out_channels):
    feature = rng.normal(size=(2, 3136, 32))
    target = rng.normal(size=(2, 64, 64, 3))
    net = JaxFtoIConv(32, out_channels=out_channels, out_size=64, dtype=jnp.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(
            net.init(jax.random.PRNGKey(0), jnp.asarray(feature, jnp.float32))))
        loss_j, g = jax.value_and_grad(
            lambda p: net.apply({"params": p}, feature, target, method="loss"))(v["params"])
        loss_j, g = float(loss_j), jax.device_get(g)
    finally:
        jax.config.update("jax_enable_x64", False)
    port = FtoIConv(32, out_channels=out_channels, out_size=64, dtype=torch.float64).double()
    port.load_state_dict(names.to_torch(names.ftoi_conv(), v))
    loss = port.loss(torch.from_numpy(feature), torch.from_numpy(target))
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    ps = dict(port.named_parameters())
    got = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    want = names.to_torch(names.ftoi_conv(), {"params": g})
    for k in got:
        _leaf_close(got[k].numpy(), want[k].numpy(), 1e-4, k, floor=1e-7)
