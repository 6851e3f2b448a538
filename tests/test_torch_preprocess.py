"""The port's preprocessing (``cmdiad_tpu_torch/preprocess/``) against the
JAX package's, on the same numpy-seeded inputs, on the CPU.

The JAX side runs its numpy and scipy paths: ``cmdiad_tpu.native.get_lib``
is patched to return None, so no test here builds the C++ library (a
build from a test worker races ``tests/test_native.py``'s own).  The
port's RANSAC draws the samples of that numpy path.

Tolerances: DBSCAN labels equal; RANSAC the same best iteration and the
plane within 1e-4 up to sign (the port fits in float64, JAX in float32);
``remove_plane`` masks equal except at points within 1e-5 of the
threshold; Eyecandies clouds within 2 float32 ulps (float64 products in
another summation order than numpy's BLAS), rgb and gt equal.  The
background of the Eyecandies fixture (an identity pose) lands on
coordinates that are float64 cancellation residue of unit-scale sums
(|x| about 1e-17, where float32 ulps mean nothing); there the two clouds
are held to 1e-15 absolute instead (measured: 1.1e-17 at most, and 0 ulps
everywhere else).
"""

import numpy as np
import pytest
import torch

import cmdiad_tpu.native as jax_native
from cmdiad_tpu.data import tiffio as jax_tiffio
from cmdiad_tpu.preprocess import cluster as jcluster
from cmdiad_tpu.preprocess import eyecandies as jeye
from cmdiad_tpu.preprocess import mvtec as jmvtec
from cmdiad_tpu.preprocess import plane as jplane
from cmdiad_tpu_torch.data import png, tiffio
from cmdiad_tpu_torch.preprocess import cluster, eyecandies, mvtec, plane
from test_misc_coverage import _build_synthetic_eyecandies
from test_preprocess import _scene

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_best_iteration(points, threshold=0.004, ransac_n=50, iters=1000, seed=0):
    """The iteration whose candidate the JAX numpy path refits."""
    idx = np.random.default_rng(seed).integers(0, len(points), size=(iters, min(ransac_n, len(points))))
    normals, d = jplane._fit_planes_batch(points[idx])
    dist = np.abs(points @ normals.T + d[None, :])
    return int(np.argmax((dist < threshold).sum(axis=0)))


def _same_plane(got, want, tol=1e-4):
    got = np.asarray(got, np.float64)
    sign = 1.0 if got[:3] @ want[:3] > 0 else -1.0
    np.testing.assert_allclose(sign * got, want, atol=tol)


@pytest.mark.parametrize("seed", [0, 3])
def test_border_points_and_ransac_match_jax(rng, seed):
    pc, _, _, _ = _scene(rng)
    pts = jplane.border_points(pc)
    tpts = plane.border_points(_t(pc))
    assert np.array_equal(tpts.numpy(), pts)
    got, best = plane.ransac(tpts, seed=seed)
    assert best == _jax_best_iteration(pts, seed=seed)
    _same_plane(got.numpy(), jplane.ransac_plane(pts, seed=seed, prefer_native=False))


def test_ransac_refits_only_on_three_inliers(rng):
    """Too few inliers: the best candidate itself, not a refit."""
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    got, best = plane.ransac(_t(pts), distance_threshold=1e-6, ransac_n=3, num_iterations=20)
    assert best == _jax_best_iteration(pts, threshold=1e-6, ransac_n=3, iters=20)
    _same_plane(got.numpy(), jplane.ransac_plane(pts, 1e-6, 3, 20, prefer_native=False))
    with pytest.raises(ValueError, match="3 border points"):
        plane.ransac_plane(_t(pts[:2]))


def test_remove_plane_matches_jax(rng):
    pc, rgb, blob, _ = _scene(rng)
    want_pc, want_rgb = jmvtec.remove_plane(pc, rgb, seed=0)
    got_pc, got_rgb = plane.remove_plane(_t(pc), _t(rgb), seed=0)
    removed = np.all(want_pc == 0, -1) & ~np.all(pc == 0, -1)
    got_removed = np.all(got_pc.numpy() == 0, -1) & ~np.all(pc == 0, -1)
    p = jplane.ransac_plane(jplane.border_points(pc), seed=0, prefer_native=False)
    dist = np.abs(pc.reshape(-1, 3).astype(np.float64) @ p[:3] + p[3]).reshape(pc.shape[:2])
    differ = removed != got_removed
    assert np.all(np.abs(dist[differ] - 0.005) < 1e-5), dist[differ]
    keep = ~differ
    assert np.array_equal(got_pc.numpy()[keep], want_pc[keep])
    assert np.array_equal(got_rgb.numpy()[keep], want_rgb[keep])
    assert removed[blob].mean() < 0.1 and removed[~blob].mean() > 0.9


def _dbscan_scene(rng, name):
    """(points (N, 3) float32, eps, min_points) of a named scene."""
    if name == "two_blobs":
        return np.concatenate([rng.normal(0, 0.001, (100, 3)),
                               rng.normal(0, 0.001, (50, 3)) + 1.0]), 0.006, 10
    if name == "bridge":
        # two dense blobs joined by a chain of core points: one cluster
        a = rng.normal(0, 0.002, (120, 3))
        b = rng.normal(0, 0.002, (120, 3)) + [0.05, 0, 0]
        chain = np.stack([np.linspace(0, 0.05, 60), np.zeros(60), np.zeros(60)], 1)
        chain = np.repeat(chain, 3, axis=0) + rng.normal(0, 1e-4, (180, 3))
        return np.concatenate([chain, b, a]), 0.006, 8
    if name == "shared_border":
        # one point within eps of two clusters that are farther apart than
        # eps: a border point of both, labelled with the smaller id
        a = rng.normal(0, 0.0005, (40, 3)) + [-0.005, 0, 0]
        b = rng.normal(0, 0.0005, (40, 3)) + [0.005, 0, 0]
        return np.concatenate([b, [[0.0, 0.0, 0.0015]], a]), 0.0045, 20
    if name == "all_noise":
        return rng.uniform(0, 1, (200, 3)), 0.006, 5
    if name == "mixed":
        blobs = [rng.normal(0, 0.003, (150, 3)) + c
                 for c in ([0, 0, 0], [0.03, 0, 0], [0, 0.03, 0.01])]
        return np.concatenate(blobs + [rng.uniform(-0.02, 0.05, (120, 3))]), 0.006, 12
    raise ValueError(name)


@pytest.mark.parametrize("name", ["two_blobs", "bridge", "shared_border", "all_noise", "mixed"])
def test_dbscan_labels_equal_jax(rng, name):
    pts, eps, min_points = _dbscan_scene(rng, name)
    pts = pts.astype(np.float32)
    want = jcluster.dbscan_labels(pts, eps, min_points, prefer_native=False)
    got = cluster.dbscan_labels(_t(pts), eps, min_points)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    expect = {"two_blobs": 2, "bridge": 1, "shared_border": 2, "all_noise": 0, "mixed": 3}
    assert int(want.max()) + 1 == expect[name]
    if name == "shared_border":
        assert want[40] == 0 and set(want[:40]) == {0} and set(want[41:]) == {1}


def test_dbscan_counts_include_the_point_itself(rng):
    pts, eps, min_points = _dbscan_scene(rng, "mixed")
    p = _t(pts.astype(np.float32))
    root, counts = cluster._roots_plain(p, eps, min_points, chunk_elems=1000)
    d = pts.astype(np.float32).astype(np.float64)
    diff = d[:, None] - d[None]
    near = (diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2 <= eps * eps
    assert np.array_equal(counts.numpy(), near.sum(1))
    assert torch.equal(root, cluster._roots_plain(p, eps, min_points)[0])


def test_cell_grid_holds_every_neighbour_pair(rng):
    """Cells a little wider than eps: every eps-pair lies in adjacent cells,
    the neighbour table names exactly the occupied ones."""
    pts = _t(np.concatenate([rng.normal(0, 0.004, (300, 3)),
                             rng.normal(0.02, 0.002, (100, 3))]).astype(np.float32))
    eps = 0.006
    order, cell_of, starts, neigh = cluster._cell_grid(pts, eps)
    assert torch.equal(torch.sort(order).values, torch.arange(len(pts)))
    p = pts[order].double().numpy()
    counts = np.zeros(len(pts), np.int64)
    for s in range(len(pts)):
        for c in neigh[cell_of[s]].tolist():
            if c >= 0:
                d = p[starts[c]:starts[c + 1]] - p[s]
                counts[s] += ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
                              <= eps * eps).sum()
    want = cluster._roots_plain(pts, eps, 10)[1].numpy()
    assert np.array_equal(counts, want[order.numpy()])


@pytest.mark.parametrize("case", ["scene", "noise_largest"])
def test_largest_cluster_cleaning_matches_jax(rng, case):
    if case == "scene":
        pc, rgb, blob, tuft = _scene(rng)
        pc, _ = jmvtec.remove_plane(pc, rgb, seed=0)
        eps, min_points = 0.02, 5
    else:
        # mostly isolated points: noise (-1) is the largest label and wins
        pc = rng.uniform(0.1, 1.0, (30, 30, 3)).astype(np.float32)
        pc[:3, :3] = 0.5 + rng.normal(0, 1e-4, (3, 3, 3))
        rgb = rng.integers(0, 255, (30, 30, 3)).astype(np.uint8)
        eps, min_points = 0.01, 5
    want = jcluster.largest_cluster_cleaning(pc, rgb, eps, min_points)
    got = cluster.largest_cluster_cleaning(_t(pc), _t(rgb), eps, min_points)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert got[2] == want[2]
    if case == "scene":
        assert np.all(want[0][tuft] == 0) and want[2] == 2
    else:
        assert want[2] == 1 and np.all(want[0][:3, :3] == 0)
    empty = np.zeros((4, 4, 3), np.float32)
    assert cluster.largest_cluster_cleaning(_t(empty), _t(empty), eps)[2] == 0


@pytest.mark.parametrize("shape", [(120, 90, 3), (50, 50), (101, 7), (200, 300, 3)])
def test_pad_to_square_matches_jax(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    assert np.array_equal(mvtec.pad_to_square(_t(x)).numpy(), jmvtec.pad_to_square(x))


def _write_sample(root, pc, rgb, gt=None):
    for sub in ("xyz", "rgb", "gt"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    tiffio.imwrite(str(root / "xyz" / "s.tiff"), pc)
    png.imwrite(root / "rgb" / "s.png", rgb)
    if gt is not None:
        png.imwrite(root / "gt" / "s.png", gt)
    return str(root / "xyz" / "s.tiff")


def _decoded(root):
    gt = root / "gt" / "s.png"
    return (tiffio.imread(str(root / "xyz" / "s.tiff")), png.imread(root / "rgb" / "s.png"),
            png.imread(gt, "L") if gt.exists() else None)


def test_preprocess_sample_matches_jax(rng, tmp_path):
    pc, rgb, blob, tuft = _scene(rng)
    gt = (blob * 255).astype(np.uint8)
    paths = {tag: _write_sample(tmp_path / tag, pc, rgb, gt) for tag in ("jax", "port")}
    want = jmvtec.preprocess_sample(paths["jax"])
    got = mvtec.preprocess_sample(paths["port"], device="cpu")
    assert set(got["timings"]) == set(mvtec.TIMING_KEYS)
    assert got["n_clusters"] == want["n_clusters"]
    for k in ("rgb", "gt"):
        assert np.array_equal(got[k], want[k]), k
    # the planes agree to 1e-4 (float64 against float32): the clouds are
    # equal wherever no point lies within 1e-5 of the removal threshold
    p = jplane.ransac_plane(jplane.border_points(pc), seed=0, prefer_native=False)
    near = np.abs(np.abs(pc.reshape(-1, 3).astype(np.float64) @ p[:3] + p[3]) - 0.005) < 1e-5
    assert not near.any()
    assert np.array_equal(got["pc"], want["pc"])
    for a, b in zip(_decoded(tmp_path / "port"), _decoded(tmp_path / "jax")):
        assert np.array_equal(a, b)
    assert got["pc"].shape == (200, 200, 3)


def test_preprocess_dataset_and_cli(rng, tmp_path, capsys):
    """The ``preprocess`` subcommand rewrites every tiff of a tree in place
    as the JAX package's ``preprocess_dataset`` does (samples without gt
    included)."""
    from cmdiad_tpu_torch import cli
    samples = []
    for i in range(3):
        pc, rgb, blob, _ = _scene(rng, h=100 + 10 * i, w=90)
        samples.append((pc, rgb, (blob * 255).astype(np.uint8) if i else None))
    for tag in ("jax", "port"):
        for i, (pc, rgb, gt) in enumerate(samples):
            _write_sample(tmp_path / tag / f"c{i}", pc, rgb, gt)
    assert jmvtec.preprocess_dataset(str(tmp_path / "jax"), num_workers=2) == 3
    n, seconds = cli.main(["preprocess", "-d", str(tmp_path / "port"), "-n", "2",
                           "--device", "cpu"])
    assert n == 3 and set(seconds) == set(mvtec.TIMING_KEYS) | {"wall_s"}
    out = capsys.readouterr().out
    assert "preprocessed 3 tiffs" in out
    for i in range(3):
        for a, b in zip(_decoded(tmp_path / "port" / f"c{i}"), _decoded(tmp_path / "jax" / f"c{i}")):
            assert (a is None and b is None) or np.array_equal(a, b)


def test_depth_normalization_reader(tmp_path):
    import yaml
    good = tmp_path / "a.yaml"
    with open(good, "w") as fh:
        yaml.safe_dump({"normalization": {"min": 0.25, "max": 1.5e3}, "other": {"k": 1},
                        "name": "x"}, fh)
    assert eyecandies.read_depth_normalization(good) == (0.25, 1500.0)
    for text in ("normalization: {min: 0.5, max: 1.5}\n",
                 "normalization:\n  - 0.5\n",
                 "normalization:\n  min: '0.5'\n  max: 1.5\n",
                 "normalization:\n  min: 0x10\n  max: 1.5\n",
                 "normalization:\n  inner:\n    min: 0.5\n",
                 "other: 1\n"):
        bad = tmp_path / "b.yaml"
        bad.write_text(text)
        with pytest.raises(ValueError):
            eyecandies.read_depth_normalization(bad)


def _ulps(a, b):
    """Distance in float32 ulps, element by element."""
    ia = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_eyecandies_conversion_matches_jax(rng, tmp_path, capsys):
    """The Eyecandies fixture at 512² through the JAX package's converter
    and the port's CLI subcommand: the same files, clouds within 2 ulps,
    rgb and gt equal (gt files hold the mask's RGB, as cv2 leaves them)."""
    from cmdiad_tpu_torch import cli
    _build_synthetic_eyecandies(rng, tmp_path / "eye", size=512)
    jeye.convert_dataset(str(tmp_path / "eye"), str(tmp_path / "jax"))
    cli.main(["preprocess-eyecandies", "--dataset_path", str(tmp_path / "eye"),
              "--target_dir", str(tmp_path / "port"), "--device", "cpu"])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len([f for f in files if f.suffix == ".tiff"]) == 4
    worst = 0
    for f in files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.suffix == ".tiff":
            got, want = tiffio.imread(str(a)), jax_tiffio.imread(str(b))
            assert got.shape == (512, 512, 3) and got.dtype == np.float32
            assert np.array_equal(np.isnan(got), np.isnan(want))
            got, want = np.nan_to_num(got), np.nan_to_num(want)
            residue = np.abs(want) < 1e-12
            assert np.abs(got - want)[residue].max(initial=0) <= 1e-15
            worst = max(worst, int(_ulps(got, want)[~residue].max(initial=0)))
        else:
            assert np.array_equal(png.imread(a), png.imread(b)), f
    assert worst <= 2, worst
    bad = tmp_path / "port" / "CandyCane" / "test" / "bad" / "gt"
    assert png.imread(next(bad.iterdir())).any()


def test_eyecandies_depth_and_projection_match_jax(rng, tmp_path):
    _build_synthetic_eyecandies(rng, tmp_path / "eye", size=512, n_train=1, n_test=0)
    d = tmp_path / "eye" / "CandyCane" / "train" / "data"
    args = [str(d / f"000_{k}") for k in ("depth.png", "info_depth.yaml", "pose.txt")]
    assert np.array_equal(eyecandies.load_depth(*args[:2], device="cpu").numpy(),
                          jeye.load_depth(*args[:2]))
    got = eyecandies.depth_to_pointcloud(*args, device="cpu").numpy()
    want = jeye.depth_to_pointcloud(*args)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    np.testing.assert_allclose(eyecandies.remove_background(torch.from_numpy(want)).numpy(),
                               jeye.remove_background(want), rtol=1e-12, atol=1e-15)


def test_png_reads_16_bit_greyscale_as_imageio(rng, tmp_path):
    import imageio.v3 as iio
    d = rng.integers(0, 65536, (37, 53)).astype(np.uint16)
    d[5:9] = 1000
    path = tmp_path / "d.png"
    iio.imwrite(path, d)
    assert np.array_equal(png.imread_grey16(path), iio.imread(path))
    assert np.array_equal(png.imread_grey16(path), d)
    png.imwrite_grey16(tmp_path / "w.png", d)
    assert np.array_equal(iio.imread(tmp_path / "w.png"), d)
    rgb = tmp_path / "rgb.png"
    png.imwrite(rgb, rng.integers(0, 255, (4, 5, 3)).astype(np.uint8))
    with pytest.raises(ValueError, match="16-bit greyscale"):
        png.imread_grey16(rgb)
    with pytest.raises(NotImplementedError, match="16-bit"):
        png.imread(path)
