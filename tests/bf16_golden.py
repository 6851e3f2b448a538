"""Saved JAX outputs of the bfloat16 backbones at full width, and their recipe.

``tests/data/jax_bf16_backbones.npz`` holds what the JAX package's
``DualBackbone`` in the throughput configuration (``compute_dtype=
'bfloat16'``, ``use_flash=True``; on the CPU its attention runs as einsums,
FPS and the interpolation as their reference paths) gives for the weights
and inputs below.  The card has no JAX, so ``chip_smoke.py`` rebuilds the
same weights and inputs there and holds the card's bfloat16 path (attention
through ``csrc/flash_attn.cu``) to the file; ``tests/test_torch_models.py``
holds the port's CPU path to it, and a test marked ``slow`` writes the file
again from JAX and checks that it is unchanged.  Write it with

    python tests/bf16_golden.py

The recipe, at the published widths and token counts:

* ViT-B/8 at 224² (785 tokens, 12 heads of 64) and Point-MAE over 1024
  groups of 128 points (1024 tokens, 6 heads of 64), each cut to its first
  ``DEPTH`` blocks of 12, Point-MAE fetching the output of both
  (``fetch_idx=(0, 1)``, 768 wide);
* weights from ``numpy.random.RandomState(SEED)``, whose stream numpy keeps
  fixed: the port's ``state_dict()`` entries in their order, LayerNorm and
  BatchNorm scales 1 + 0.1 N(0, 1), biases and BatchNorm means 0.1 N(0, 1),
  BatchNorm variances U(0.5, 1.5), every other tensor N(0, 1) / sqrt(fan
  in) (the class token and the position embedding N(0, 1)): attention
  scores of order one, so the softmax is far from uniform;
* inputs from ``RandomState(SEED + 1)``: ``BATCH`` images N(0, 1) and
  organized clouds N(0, 0.05²) valid on a disc of radius 90 pixels (about
  25k of 50176 points, compacted to 32768 slots as the default does).

Stored: ``ROWS`` rows of each output drawn by ``RandomState(SEED + 2)``,
each output's per-channel mean and norm over all its rows (float64 sums,
stored float32), and every sample's FPS center indices.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent / "data" / "jax_bf16_backbones.npz"
SEED = 0
BATCH = 2
DEPTH = 2
ROWS = 48
SIZE = 224
OUTPUTS = ("rgb_patch", "group_feats", "xyz_patch")

# How far the card's bfloat16 path may lie from JAX's, in units of
# ``scale`` = the largest |value| of the stored output.  One bfloat16
# rounding moves a value by up to 2^-9 of itself; the two packages round at
# different places (JAX's einsum attention rounds scores and probabilities
# to bfloat16, the fused kernel keeps them in float32; sums run in other
# orders), some ten roundings on the way through two blocks, each carried
# on by the layers after it.  Rows: 2^-4 of the scale (8 bfloat16 steps at
# the largest value); the per-channel means and norms average 1568 to 6272
# rows, so their independent rounding noise shrinks: 2^-7 of the scale.
ROW_TOL = 2.0 ** -4
SUMMARY_TOL = 2.0 ** -7


def vit_kwargs() -> dict:
    return dict(depth=DEPTH)


def point_kwargs() -> dict:
    return dict(depth=DEPTH, fetch_idx=tuple(range(DEPTH)))


def recipe_state_dict(template: dict, rs: np.random.RandomState) -> dict:
    """Float32 numpy weights for every entry of ``template`` (a port
    module's ``state_dict()``), drawn in its order."""
    out = {}
    for name, t in template.items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[name] = np.zeros(shape, np.int64)
            continue
        if leaf == "running_var":
            v = rs.uniform(0.5, 1.5, shape)
        elif leaf in ("bias", "running_mean"):
            v = 0.1 * rs.standard_normal(shape)
        elif len(shape) == 1:                       # LayerNorm / BatchNorm scales
            v = 1.0 + 0.1 * rs.standard_normal(shape)
        elif name in ("cls_token", "pos_embed", "cls_pos"):
            v = rs.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rs.standard_normal(shape) / np.sqrt(fan_in)
        out[name] = v.astype(np.float32)
    return out


def inputs():
    """(images (BATCH, 224, 224, 3), organized clouds (BATCH, 224, 224, 3)),
    float32."""
    rs = np.random.RandomState(SEED + 1)
    images = rs.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    pc = (rs.standard_normal((BATCH, SIZE, SIZE, 3)) * 0.05).astype(np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    pc[:, ((yy - SIZE // 2) ** 2 + (xx - SIZE // 2) ** 2) > 90 ** 2] = 0.0
    return images, pc


def port_backbone(device):
    """The port's bfloat16 ``DualBackbone`` (fused attention) with the
    recipe's weights, on ``device``; -> (backbone, numpy state dicts
    {'vit': ..., 'point': ...})."""
    from cmdiad_tpu_torch.models.backbone import DualBackbone
    from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
    from cmdiad_tpu_torch.models.vit import ViTConfig
    import torch

    tb = DualBackbone(vit_config=ViTConfig(**vit_kwargs()),
                      pm_config=PointMAEConfig(**point_kwargs()),
                      compute_dtype="bfloat16", use_flash=True, device="cpu")
    rs = np.random.RandomState(SEED)
    sds = {"vit": recipe_state_dict(tb.vit.state_dict(), rs),
           "point": recipe_state_dict(tb.point.state_dict(), rs)}
    for name in ("vit", "point"):
        getattr(tb, name).load_state_dict(
            {k: torch.from_numpy(v) for k, v in sds[name].items()})
    return tb.to(device), sds


def _rows(n_rows: int) -> np.ndarray:
    return np.sort(np.random.RandomState(SEED + 2).choice(n_rows, ROWS, replace=False))


def summarize(out: dict) -> dict:
    """The stored form of a backbone's outputs (numpy arrays by name)."""
    res = {}
    for key in OUTPUTS:
        x = np.asarray(out[key], np.float32)
        flat = x.reshape(-1, x.shape[-1])
        res[f"{key}_rows"] = flat[_rows(len(flat))]
        res[f"{key}_mean"] = flat.mean(0, dtype=np.float64).astype(np.float32)
        res[f"{key}_norm"] = np.sqrt((flat.astype(np.float64) ** 2).sum(0)).astype(np.float32)
    res["center_idx"] = np.asarray(out["center_idx"], np.int32)
    return res


def deviations(got: dict, want: dict) -> dict:
    """Per stored entry, the largest |got - want| in units of its output's
    scale (the largest |value| of the stored rows; the norms in units of
    their own largest value); the FPS indices as the count that differ."""
    res = {}
    for key in OUTPUTS:
        scale = float(np.abs(want[f"{key}_rows"]).max())
        for part in ("rows", "mean"):
            name = f"{key}_{part}"
            res[name] = float(np.abs(got[name] - want[name]).max()) / scale
        norm = want[f"{key}_norm"]
        res[f"{key}_norm"] = float(np.abs(got[f"{key}_norm"] - norm).max() / norm.max())
    res["center_idx"] = int((got["center_idx"] != want["center_idx"]).sum())
    return res


def check(got: dict, want: dict) -> dict:
    """Raise unless ``got`` lies within the tolerances of ``want``; ->
    the deviations."""
    dev = deviations(got, want)
    bad = {k: v for k, v in dev.items()
           if (k == "center_idx" and v) or
           (k != "center_idx" and v > (ROW_TOL if k.endswith("_rows") else SUMMARY_TOL))}
    assert not bad, f"bf16 backbones off the JAX outputs: {bad} (all: {dev})"
    return dev


def jax_outputs() -> dict:
    """The JAX package's outputs for the recipe (CPU), summarized."""
    import jax
    import jax.numpy as jnp

    from cmdiad_tpu.models.backbone import DualBackbone as JaxBackbone
    from cmdiad_tpu.models.point_mae import PointMAEConfig as JaxPM
    from cmdiad_tpu.models.vit import ViTConfig as JaxViT
    from cmdiad_tpu_torch.models import convert

    _, sds = port_backbone("cpu")
    params = {"vit": convert.vit_from_timm(sds["vit"], depth=DEPTH),
              "point": convert.point_mae_from_torch(sds["point"], depth=DEPTH)}
    jb = JaxBackbone(vit_config=JaxViT(**vit_kwargs()), pm_config=JaxPM(**point_kwargs()),
                     compute_dtype="bfloat16", use_pallas=False, use_flash=True,
                     image_size=SIZE)
    params = jax.tree.map(jnp.asarray, params)
    images, pc = inputs()
    out = jb.extract(params, images=jnp.asarray(images), organized_pc=jnp.asarray(pc))
    return summarize({k: np.asarray(v) for k, v in out.items()})


def write(path: Path = GOLDEN) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **jax_outputs())


def load(path: Path = GOLDEN) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))    # the repository
    import jax
    # the CPU and the matmul precision that tests/conftest.py sets
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    write(Path(sys.argv[1]) if len(sys.argv) > 1 else GOLDEN)
    print(f"wrote {GOLDEN if len(sys.argv) < 2 else sys.argv[1]}")
