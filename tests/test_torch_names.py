"""The backbones' name tables (``models.names.vit``, ``models.names.point_mae``)
against the port's modules and the JAX package's checkpoint converters.

For each backbone flavour at tiny widths: the table names every entry of
the module's state dict (a strict load passes), ``to_flax(to_torch(v))``
gives ``v`` back bit for bit, and ``to_flax`` over a reference-named state
dict is what ``cmdiad_tpu.models.convert`` writes, bit for bit.
"""

import numpy as np
import pytest

from cmdiad_tpu.models import convert as jax_convert
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig, PointTransformer
from cmdiad_tpu_torch.models.vit import ViTConfig, VisionTransformer

CASES = {
    "vit_b8": ViTConfig(img_size=16, embed_dim=8, depth=2, num_heads=2),
    "dinov2_layer_scale": ViTConfig(img_size=28, patch_size=14, embed_dim=8, depth=2,
                                    num_heads=2, layer_scale=True),
    "dinov2_reg4_depth24": ViTConfig(img_size=28, patch_size=14, embed_dim=8, depth=24,
                                     num_heads=2, layer_scale=True, num_reg_tokens=4),
    "point_mae": PointMAEConfig(encoder_dims=8, trans_dim=8, depth=2, num_heads=2,
                                fetch_idx=(0, 1)),
    "point_bert": PointMAEConfig(encoder_dims=16, trans_dim=8, depth=2, num_heads=2,
                                 fetch_idx=(0, 1)),
}


def _assert_trees_equal(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], path + (k,))
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("case", list(CASES))
def test_backbone_table_matches_module_and_jax_converter(case):
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    if isinstance(c, ViTConfig):
        module = VisionTransformer(c)
        table = names.vit(c.depth, c.layer_scale, c.num_reg_tokens > 0, c.qkv_bias)
        jax_writer = jax_convert.vit_from_timm
    else:
        module = PointTransformer(c)
        table = names.point_mae(c.depth, module.with_cls, c.qkv_bias)
        jax_writer = jax_convert.point_mae_from_torch
    # a reference-named state dict with a value of its own in every entry
    sd = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}
    if isinstance(c, PointMAEConfig):
        sd["blocks.blocks.0.attn.qkv.bias"] = np.ones(3 * c.trans_dim, np.float32)  # dropped

    variables = names.to_flax(table, sd)
    back = names.to_torch(table, variables)
    assert set(back) == set(module.state_dict())
    module.load_state_dict(back, strict=True)
    _assert_trees_equal(names.to_flax(table, back), variables)
    _assert_trees_equal(variables, jax_writer(sd, depth=c.depth))
