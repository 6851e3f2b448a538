"""One HRNet (input-to-feature) training step, the port's against the JAX
trainer's, for both ItoF train methods: out_dim 32, 224² inputs, 56² grid,
batch 1.  Loss and BatchNorm statistics in float32, gradients in float64
(tolerances and why: ``test_torch_train.py``)."""

import numpy as np
import pytest
import torch

from test_torch_train import BASE, check_step

torch.set_num_threads(2)


@pytest.mark.parametrize("tm", ["RGBInputToXYZFeatureHRNET", "XYZInputToRGBFeatureHRNET"])
def test_hrnet_step(tmp_path, rng, tm):
    arrays = {"image": rng.normal(size=(1, 224, 224, 3)).astype(np.float32),
              "feature": rng.normal(size=(1, 3136, 32)).astype(np.float32)}
    check_step(tmp_path, dict(BASE, train_method=tm), 32, arrays, n=1, grads="float64")
