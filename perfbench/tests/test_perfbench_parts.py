"""The part generator: deterministic per seed, every seed the same set of
sizes, valid points in the traffic's range, the RGB image at a side of its
own."""

import json

import numpy as np

from perfbench.core import parts, spec

B8 = json.loads((spec.BENCH_DIR / "traffic" / "closed_b8.json").read_text())


def test_same_seed_same_parts():
    a = parts.make_parts(2 ** 31 + 11, 4, B8, 0.5, "pool")
    b = parts.make_parts(2 ** 31 + 11, 4, B8, 0.5, "pool")
    for x, y in zip(a, b):
        for k in ("rgb", "organized_pc", "points_compact", "gt"):
            np.testing.assert_array_equal(x[k], y[k])
        assert x["label"] == y["label"]
    c = parts.make_parts(2 ** 31 + 12, 4, B8, 0.5, "pool")
    assert any(not np.array_equal(x["organized_pc"], y["organized_pc"]) for x, y in zip(a, c))


def test_valid_points_in_range_and_the_same_set_for_every_seed():
    lo, hi = B8["valid_points"]
    counts = {}
    for seed in (0, 4_000_000_123):
        pool = parts.make_parts(seed, B8["pool"], B8, B8["defect_share"], "pool")
        n = np.array([parts.valid_points(p) for p in pool])
        assert n.min() >= lo and n.max() <= hi, (n.min(), n.max())
        assert sum(p["label"] for p in pool) == B8["pool"] // 2
        for p in pool:
            v = parts.valid_points(p)
            assert np.all(p["points_compact"][:v] != 0) and np.all(p["points_compact"][v:] == 0)
            assert p["gt"].sum() > 0 if p["label"] else p["gt"].sum() == 0
        counts[seed] = np.sort(n)
    # the same sizes in another order: a disc's lattice count moves by under 1 %
    np.testing.assert_allclose(counts[0], counts[4_000_000_123], rtol=0.01)


def test_the_rgb_image_at_a_side_of_its_own_is_the_cloud_side_image_resized():
    seed = 2 ** 31 + 13
    plain = parts.make_parts(seed, 4, B8, 0.5, "pool")
    same = parts.make_parts(seed, 4, B8, 0.5, "pool", B8["size"])
    wide = parts.make_parts(seed, 4, B8, 0.5, "pool", 518)
    for p, s, w in zip(plain, same, wide):
        for k in ("rgb", "organized_pc", "points_compact", "gt"):
            np.testing.assert_array_equal(p[k], s[k])
        for k in ("organized_pc", "points_compact", "gt"):
            np.testing.assert_array_equal(p[k], w[k])
        assert p["label"] == w["label"] and w["rgb"].shape == (518, 518, 3)
        u8 = np.round((p["rgb"] * parts.IMAGENET_STD + parts.IMAGENET_MEAN) * 255).astype(np.uint8)
        resized = parts.resize_bicubic(u8, 518).astype(np.float32) / 255.0
        np.testing.assert_array_equal((resized - parts.IMAGENET_MEAN) / parts.IMAGENET_STD,
                                      w["rgb"])
