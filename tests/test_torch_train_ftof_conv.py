"""FtoFConv training, the port's against the JAX trainer's.

* one step of the train method at the net's fixed width (768) and grid
  (3136 tokens), batch 1, with and without ``sigmoid_loss``: losses and the
  BatchNorm statistics after the step in float32 (tolerances:
  ``test_torch_train.py``);
* the gradients of the net's part with BatchNorm in training mode, a conv
  stack (three conv + BatchNorm + ReLU, then a conv; 768 wide), in float64
  in both packages at 1e-4 of a leaf's largest, on a 6x8 grid: float32
  keeps few digits of these gradients (``test_torch_train.py``), and the
  JAX package's float64 convolutions on the CPU would take minutes at
  56x56.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu.models.hallucination import _ConvStack
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.models.hallucination import FtoFConv, _run_conv_stack
from test_torch_train import BASE, _leaf_close, check_step

torch.set_num_threads(2)


@pytest.mark.parametrize("sigmoid", [False, True])
def test_ftof_conv_step(tmp_path, rng, sigmoid):
    arrays = {"patch": rng.normal(size=(1, 3136, 1536)).astype(np.float32)}
    check_step(tmp_path, dict(BASE, train_method="HallucinationCrossModalityConv",
                              sigmoid_loss=sigmoid), 768, arrays, n=1, grads=None)


def test_ftof_conv_stack_gradients_in_float64(rng):
    x = rng.normal(size=(2, 6, 8, 768))
    w = rng.normal(size=(2, 6, 8, 768))
    stack = _ConvStack(768, dtype=jnp.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(
            stack.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))))

        def lf(p):
            y, upd = stack.apply({"params": p, "batch_stats": v["batch_stats"]}, x, True,
                                 mutable=["batch_stats"])
            return jnp.sum(y * w), upd
        (_, upd), g = jax.value_and_grad(lf, has_aux=True)(v["params"])
        g, upd = jax.device_get(g), jax.device_get(upd)
    finally:
        jax.config.update("jax_enable_x64", False)
    table = [(k[len("xyz_conv."):], p[:1] + p[2:], t) for k, p, t in names.ftof_conv()
             if k.startswith("xyz_conv.")]
    port = FtoFConv(768, 768).xyz_conv.double()
    port.load_state_dict(names.to_torch(table, v))
    y = _run_conv_stack(port, torch.from_numpy(x).permute(0, 3, 1, 2), True)
    loss = (y * torch.from_numpy(w).permute(0, 3, 1, 2)).sum()
    ps = dict(port.named_parameters())
    got = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    want = names.to_torch(table, {"params": g})
    for k in got:
        _leaf_close(got[k].numpy(), want[k].numpy(), 1e-4, k, floor=1e-7)
    stats = names.to_flax(table, port.state_dict())["batch_stats"]
    for name, leaf in stats.items():
        for s in ("mean", "var"):
            _leaf_close(leaf[s], upd["batch_stats"][name][s], 1e-5, f"{name}.{s}")
