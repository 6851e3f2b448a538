"""The port's backbones against the JAX package's, with the JAX random
parameters carried across by ``models.bridge``.

float32 on both sides: features agree to about 1e-5 relative (summation
order, and Flax's E[x²]−E[x]² LayerNorm variance against PyTorch's).
FPS and KNN pick the same centres and neighbour sets on these inputs.
bfloat16 on both sides: features agree to a few bfloat16 ulps, at small
widths here and at full width against the JAX outputs saved in
``tests/data/jax_bf16_backbones.npz`` (``tests/bf16_golden.py``), which the
card is held to as well.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bf16_golden
from cmdiad_tpu.data.synthetic import _blob_pc
from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
from cmdiad_tpu.models.vit import ViTConfig as JaxViT
from cmdiad_tpu_torch.models.backbone import DualBackbone
from cmdiad_tpu_torch.models.bridge import load_jax_params, vit_state_dict
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(2)

SIZE = 64
SMALL_VIT = dict(img_size=SIZE, patch_size=8, embed_dim=32, depth=2, num_heads=2)
SMALL_PM = dict(num_group=32, group_size=16, encoder_dims=16, trans_dim=16,
                depth=2, num_heads=2, fetch_idx=(0, 1))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def pair():
    jb = JaxBackbone(vit_config=JaxViT(**SMALL_VIT), pm_config=JaxPM(**SMALL_PM),
                     use_pallas=False, image_size=SIZE)
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT),
                      pm_config=PointMAEConfig(**SMALL_PM),
                      device="cpu")
    load_jax_params(tb, params)
    return jb, params, tb


def test_bridge_covers_every_parameter(pair):
    _, params, tb = pair
    assert set(vit_state_dict(params["vit"])) == set(tb.vit.state_dict())
    n_jax = sum(np.size(x) for x in jax.tree.leaves(params))
    n_port = sum(t.numel() for m in (tb.vit, tb.point)
                 for k, t in m.state_dict().items() if "num_batches" not in k)
    assert n_jax == n_port


def test_vit_rgb_patches_match(pair, rng):
    jb, params, tb = pair
    img = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want, want2 = jb.rgb_patches(params, jnp.asarray(img))
    got, got2 = tb.rgb_patches(torch.from_numpy(img))
    assert got.shape == (2, 64, 32) and got2.shape == (2, 3136, 32)
    _close(got.numpy(), want)
    _close(got2.numpy(), want2)


@pytest.mark.parametrize("capacity", [None, 2048])
def test_point_mae_xyz_patches_match(pair, capacity):
    """Full xyz path: masked FPS, KNN, group encoder (first dense before the
    gather), transformer {0, 1}, 3-NN interpolation on the full grid and the
    3x3 + adaptive pool to 56²; with capacity the valid points are
    compacted first (same selections, exactly)."""
    jb, params, tb = pair
    pcs = np.stack([_blob_pc(np.random.default_rng(i), SIZE)[0] for i in range(2)])
    compact = None
    if capacity:
        from cmdiad_tpu_torch.ops.masked import host_compact_points
        compact = np.stack([host_compact_points(p, capacity) for p in pcs])
    want = jb.xyz_patches(params, jnp.asarray(pcs),
                          compact_pts=None if compact is None else jnp.asarray(compact))
    got = tb.xyz_patches(torch.from_numpy(pcs),
                         None if compact is None else torch.from_numpy(compact))
    np.testing.assert_array_equal(got["center_idx"].numpy(), np.asarray(want["center_idx"]))
    # neighbour SETS agree; the order inside a set may differ where grid
    # points tie to the last ulp (the encoder max-pools over the set)
    np.testing.assert_array_equal(np.sort(got["ori_idx"].numpy(), -1),
                                  np.sort(np.asarray(want["ori_idx"]), -1))
    _close(got["group_feats"].numpy(), want["group_feats"])
    _close(got["xyz_patch"].numpy(), want["xyz_patch"])


@pytest.mark.parametrize("use_flash", [False, True])
def test_models_run_in_bfloat16(rng, use_flash):
    """bfloat16 backbones against the JAX package's, bridged parameters.
    Both round every layer's output to bfloat16 at the same points but sum
    in other float32 orders, so now and then an element lands on the other
    bfloat16 neighbour (2^-8 relative) and that carries through the blocks:
    held to 4 ulps of the largest feature and 2 ulps on average.  On the
    CPU the JAX package runs ``use_flash`` as its einsum form; the port runs
    the fused kernel's plain version (unrounded float32 scores)."""
    jb = JaxBackbone(vit_config=JaxViT(**SMALL_VIT), pm_config=JaxPM(**SMALL_PM),
                     use_pallas=False, image_size=SIZE, compute_dtype="bfloat16",
                     use_flash=use_flash)
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(vit_config=ViTConfig(**SMALL_VIT),
                      pm_config=PointMAEConfig(**SMALL_PM),
                      compute_dtype="bfloat16", use_flash=use_flash, device="cpu")
    load_jax_params(tb, params)
    img = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    pcs = np.stack([_blob_pc(np.random.default_rng(i), SIZE)[0] for i in range(2)])
    want = dict(zip(("rgb_patch", "rgb_patch2"),
                    jb.rgb_patches(params, jnp.asarray(img))))
    want.update(jb.xyz_patches(params, jnp.asarray(pcs)))
    got = tb.extract(images=torch.from_numpy(img), organized_pc=torch.from_numpy(pcs))
    np.testing.assert_array_equal(got["center_idx"].numpy(), np.asarray(want["center_idx"]))
    ulp = 2.0 ** -8
    for k in ("rgb_patch", "rgb_patch2", "group_feats", "xyz_patch"):
        assert got[k].dtype == torch.float32, k
        g, w = got[k].numpy(), np.asarray(want[k], np.float32)
        diff = np.abs(g - w)
        assert diff.max() <= 4 * ulp * np.abs(w).max(), (k, diff.max())
        assert diff.mean() <= 2 * ulp * np.abs(w).mean(), (k, diff.mean())


def test_bf16_backbones_hold_to_the_saved_jax_outputs():
    """ViT-B/8 at 224² and Point-MAE over 1024 groups of 128, two blocks
    each, bfloat16 with the fused attention's plain version: the port's CPU
    path within ``bf16_golden``'s tolerances of the saved JAX outputs, the
    FPS centres equal."""
    tb, _ = bf16_golden.port_backbone("cpu")
    images, pc = bf16_golden.inputs()
    out = tb.extract(images=torch.from_numpy(images), organized_pc=torch.from_numpy(pc))
    got = bf16_golden.summarize({k: v.numpy() for k, v in out.items()})
    print(bf16_golden.check(got, bf16_golden.load()))


@pytest.mark.slow
def test_saved_jax_bf16_outputs_are_reproduced():
    """The saved JAX outputs are what the JAX package gives for
    ``bf16_golden``'s recipe today, bit for bit."""
    want = bf16_golden.load()
    got = bf16_golden.jax_outputs()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.slow
def test_full_width_backbones_match():
    """ViT-B/8 + Point-MAE at 224² with 1024 groups of 128 (slow on CPU)."""
    jb = JaxBackbone(use_pallas=False)
    params = jax.device_get(jb.init_params(0))
    tb = DualBackbone(device="cpu")
    load_jax_params(tb, params)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(1, 224, 224, 3)).astype(np.float32)
    _close(tb.rgb_patches(torch.from_numpy(img))[0].numpy(),
           jb.rgb_patches(params, jnp.asarray(img))[0], rtol=1e-4)
    pc = _blob_pc(rng, 224)[0][None]
    _close(tb.xyz_patches(torch.from_numpy(pc))["xyz_patch"].numpy(),
           jb.xyz_patches(params, jnp.asarray(pc))["xyz_patch"], rtol=1e-4)
