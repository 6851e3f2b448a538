"""The port's data layer against Pillow and the JAX package, exactly.

* ``data.png`` decodes what Pillow writes (L, LA, RGB, RGBA, P at 8 and 4
  bits, 1-bit) and what its own encoder writes to Pillow's
  ``Image.open(...).convert(mode)`` arrays, over images whose rows carry all
  five PNG filter types;
* ``data.resize`` gives Pillow's bicubic and NEAREST resizes byte for byte,
  and the JAX package's point-cloud nearest rule index for index;
* ``data.tiffio`` and the JAX package's TIFF codec read each other's files
  and Pillow's compressed ones to the same arrays;
* ``data.mvtec3d.MVTec3DDataset`` gives the JAX dataset's samples, every
  key, for train, train_validation and test;
* ``data.synthetic.make_synthetic_dataset`` writes the JAX writer's pixels.

Every comparison is exact: 0 differing bytes or values.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cmdiad_tpu.data import mvtec3d as jax_mvtec
from cmdiad_tpu.data import tiffio as jax_tiffio
from cmdiad_tpu.data.synthetic import make_synthetic_dataset as jax_make_dataset
from cmdiad_tpu.ops.pooling import nearest_resize_np as jax_nearest_resize_np
from cmdiad_tpu.data.loader import iter_samples as jax_iter_samples
from cmdiad_tpu_torch.data import png, tiffio
from cmdiad_tpu_torch.data.loader import iter_samples
from cmdiad_tpu_torch.data.mvtec3d import MVTec3DDataset
from cmdiad_tpu_torch.data.resize import (nearest_resize_np, pil_bicubic_resize_u8,
                                          pil_nearest_resize_u8)
from cmdiad_tpu_torch.data.synthetic import make_synthetic_dataset, synthetic_files


def _pil_png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:120, 0:130]
    smooth = np.stack([(2 * xx) % 256, (2 * yy) % 256, (xx + yy) % 256], -1)
    noisy = rng.integers(0, 256, (97, 101, 3))
    return {"smooth": smooth.astype(np.uint8), "noisy": noisy.astype(np.uint8)}


KINDS = {
    "RGB": lambda im: im,
    "RGBA": lambda im: im.convert("RGBA"),
    "L": lambda im: im.convert("L"),
    "LA": lambda im: im.convert("LA"),
    "P": lambda im: im.convert("P", palette=Image.ADAPTIVE, colors=200),
    "P4": lambda im: im.convert("P", palette=Image.ADAPTIVE, colors=12),
    "1": lambda im: im.convert("1"),
}


@pytest.mark.parametrize("image", ["smooth", "noisy"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_decode_matches_pillow(image, kind):
    data = _pil_png(KINDS[kind](Image.fromarray(_images()[image])))
    for mode in ("RGB", "L"):
        want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
        got = png.decode(data, mode)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert int((got != want).sum()) == 0, (image, kind, mode)


@pytest.mark.parametrize("image", ["smooth", "noisy"])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_encoder_round_trips_and_pillow_reads_it(image, channels):
    arr = _images()[image]
    if channels == 1:
        arr = np.asarray(Image.fromarray(arr).convert("L"))
    data = png.encode(arr)
    mode = "L" if channels == 1 else "RGB"
    assert np.array_equal(png.decode(data, mode), arr)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)
    assert np.array_equal(png.decode(data, "RGB" if channels == 1 else "L"),
                          np.asarray(Image.open(io.BytesIO(data)).convert(
                              "RGB" if channels == 1 else "L")))


def test_all_five_filter_types_occur():
    """The images above carry every row filter, so the decode tests undo
    all five: Pillow writes None, Sub, Up and Paeth, the port's encoder
    also Average."""
    seen = set()
    for arr in _images().values():
        for kind in KINDS.values():
            seen |= set(png.row_filters(_pil_png(kind(Image.fromarray(arr)))).tolist())
        seen |= set(png.row_filters(png.encode(arr)).tolist())
    assert seen == {0, 1, 2, 3, 4}


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def test_png_refuses_interlaced_16_bit_and_corrupt_files(tmp_path):
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    path = tmp_path / "adam7.png"
    path.write_bytes(png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IEND", b""))
    with pytest.raises(NotImplementedError, match="adam7.png.*interlaced"):
        png.imread(path)
    path = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    with pytest.raises(NotImplementedError, match="deep.png.*16-bit"):
        png.imread(path, "L")
    data = bytearray(png.encode(np.zeros((4, 4), np.uint8)))
    data[40] ^= 0xFF                                   # inside the IDAT body
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))


@pytest.mark.parametrize("n_in", [64, 400, 800, 900])
def test_bicubic_resize_matches_pillow(n_in):
    rng = np.random.default_rng(n_in)
    img = rng.integers(0, 256, (n_in, n_in, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((224, 224), Image.BICUBIC))
    got = pil_bicubic_resize_u8(img, 224)
    assert got.dtype == np.uint8 and int((got != want).sum()) == 0


def test_bicubic_resize_matches_pillow_off_square():
    img = np.random.default_rng(1).integers(0, 256, (333, 517, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((211, 100), Image.BICUBIC))
    assert np.array_equal(pil_bicubic_resize_u8(img, (100, 211)), want)


@pytest.mark.parametrize("n_in,n_out", [(64, 224), (400, 224), (800, 224),
                                        (900, 224), (800, 56)])
def test_nearest_resize_matches_pillow(n_in, n_out):
    img = np.random.default_rng(n_in).integers(0, 256, (n_in, n_in), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((n_out, n_out), Image.NEAREST))
    assert np.array_equal(pil_nearest_resize_u8(img, n_out), want)


@pytest.mark.parametrize("n_in", [300, 600, 800])
def test_point_cloud_nearest_resize_matches_jax(n_in):
    pc = np.random.default_rng(n_in).normal(size=(n_in, n_in, 3)).astype(np.float32)
    assert np.array_equal(nearest_resize_np(pc, 224), jax_nearest_resize_np(pc, 224))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.uint16])
def test_tiff_round_trips_both_ways(tmp_path, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(17, 23, 3)) * 100).astype(dtype)
    tiffio.imwrite(str(tmp_path / "port.tiff"), arr)
    jax_tiffio.imwrite(str(tmp_path / "jax.tiff"), arr)
    assert (tmp_path / "port.tiff").read_bytes() == (tmp_path / "jax.tiff").read_bytes()
    for path in ("port.tiff", "jax.tiff"):
        got = tiffio.imread(str(tmp_path / path))
        assert got.dtype == arr.dtype and np.array_equal(got, arr)
        # the JAX package's native fast path reads every uncompressed file
        # as float32, so its reader is held to the values
        assert np.array_equal(jax_tiffio.imread(str(tmp_path / path)), arr)


@pytest.mark.parametrize("compression,predictor", [
    ("tiff_deflate", None), ("tiff_lzw", None), ("packbits", None),
    ("tiff_lzw", 2), ("tiff_adobe_deflate", 2)])
def test_tiff_reads_compressed_files_as_the_jax_reader(tmp_path, compression, predictor):
    rng = np.random.default_rng(1)
    arr = (rng.normal(size=(40, 31)) * 100).astype(np.int16 if predictor else np.float32)
    path = str(tmp_path / "c.tiff")
    Image.fromarray(arr).save(path, format="TIFF", compression=compression,
                              **({"tiffinfo": {317: predictor}} if predictor else {}))
    got = tiffio.imread(path)
    assert np.array_equal(got, jax_tiffio.imread(path)) and np.array_equal(got, arr)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """The JAX writer's 64² fixture, plus two 800² samples of another class
    written with Pillow and the JAX TIFF writer."""
    root = str(tmp_path_factory.mktemp("mvtec"))
    jax_make_dataset(root, class_names=("widget",), n_train=3, n_test_good=2,
                     n_test_bad=2, n_test_color=1, size=64, seed=0)
    rng = np.random.default_rng(5)
    for split, defect in (("train", "good"), ("validation", "good"),
                          ("test", "good"), ("test", "crack")):
        base = os.path.join(root, "scan", split, defect)
        for sub in ("rgb", "xyz") + (("gt",) if defect != "good" else ()):
            os.makedirs(os.path.join(base, sub))
        yy, xx = np.mgrid[0:800, 0:800] / 800.0
        rgb = np.stack([xx, yy, xx * yy], -1) * 200 + rng.integers(0, 50, (800, 800, 3))
        Image.fromarray(rgb.astype(np.uint8)).save(os.path.join(base, "rgb", "000.png"))
        pc = np.stack([xx, yy, 0.3 + 0.1 * xx * yy], -1).astype(np.float32)
        pc[(xx - 0.5) ** 2 + (yy - 0.5) ** 2 > 0.16] = 0.0
        jax_tiffio.imwrite(os.path.join(base, "xyz", "000.tiff"), pc)
        if defect != "good":
            gt = ((xx - 0.4) ** 2 + (yy - 0.55) ** 2 < 0.01) * 255
            Image.fromarray(gt.astype(np.uint8)).save(os.path.join(base, "gt", "000.png"))
    return root


@pytest.mark.parametrize("cls", ["widget", "scan"])
@pytest.mark.parametrize("split", ["train", "train_validation", "test"])
def test_dataset_matches_jax_sample_for_sample(dataset_root, cls, split):
    """At the default 224² sizes: the 64² samples are upscaled, the 800²
    ones downscaled, and points_compact is filled (50176 cells > 32768)."""
    ours = MVTec3DDataset(dataset_root, cls, split)
    theirs = jax_mvtec.MVTec3DDataset(dataset_root, cls, split)
    assert [r.__dict__ for r in ours.records] == [r.__dict__ for r in theirs.records]
    assert len(ours) > 0
    for i in range(len(ours)):
        a, b = ours.load(i), theirs.load(i)
        assert sorted(a) == sorted(b)
        assert {"rgb", "organized_pc", "depth3", "points_compact"} <= set(a)
        assert ("gt" in a) == (split == "test")
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (split, i, k)
            else:
                assert a[k] == b[k], (split, i, k)


def test_dataset_sizes_follow_the_config(dataset_root):
    """rgb and depth at rgb_size, the cloud at xyz_size, gt at gt_size; no
    compaction when the grid holds fewer cells than the capacity."""
    ours = MVTec3DDataset(dataset_root, "widget", "test", rgb_size=64, xyz_size=96,
                          gt_size=56)
    theirs = jax_mvtec.MVTec3DDataset(dataset_root, "widget", "test", rgb_size=64,
                                      xyz_size=96, gt_size=56)
    for i in range(len(ours)):
        a, b = ours.load(i), theirs.load(i)
        assert a["rgb"].shape == (64, 64, 3) and a["depth3"].shape == (64, 64, 3)
        assert a["organized_pc"].shape == (96, 96, 3) and a["gt"].shape == (56, 56)
        assert "points_compact" not in a
        for k in ("rgb", "organized_pc", "depth3", "gt"):
            assert np.array_equal(a[k], b[k]), k


def test_synthetic_dataset_writes_the_jax_writers_pixels(tmp_path):
    kw = dict(class_names=("a", "b"), n_train=2, n_test_good=1, n_test_bad=2,
              n_test_color=2, size=48, seed=7, anomaly_radius=(0.13, 0.18))
    make_synthetic_dataset(str(tmp_path / "port"), **kw)
    jax_make_dataset(str(tmp_path / "jax"), **kw)
    rels = [rel for rel, _ in synthetic_files(**kw)]
    found = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert sorted(rels) == found
    for rel, arr in synthetic_files(**kw):
        port, jax = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.endswith(".png"):
            want = np.asarray(Image.open(jax))
            assert np.array_equal(np.asarray(Image.open(port)), want), rel
            assert np.array_equal(png.imread(port, "L" if arr.ndim == 2 else "RGB"), want)
        else:
            want = jax_tiffio.imread(str(jax))
            assert np.array_equal(tiffio.imread(str(port)), want), rel
        assert np.array_equal(arr, want), rel


class _SlowFirst:
    """A dataset whose first samples take longest to load, so a loader that
    yielded in completion order would reorder them."""

    def __len__(self):
        return 9

    def load(self, i):
        import time
        time.sleep(0.002 * (9 - i))
        return {"i": i}


@pytest.mark.parametrize("workers,cap", [(0, None), (3, None), (3, 4), (6, 20)])
def test_iter_samples_keeps_order_and_cap(workers, cap):
    got = [s["i"] for s in iter_samples(_SlowFirst(), num_workers=workers,
                                        prefetch=4, max_samples=cap)]
    want = [s["i"] for s in jax_iter_samples(_SlowFirst(), num_workers=workers,
                                             prefetch=4, max_samples=cap)]
    assert got == want == list(range(min(9, cap or 9)))
