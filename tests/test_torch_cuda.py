"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies (the multi-device cases spawn their ranks with
``cmdiad_tpu_torch.parallel.launch`` and ``tests/torch_parallel_workers.py``):

    python -m pytest -q --noconftest tests/test_torch_cuda.py

FPS, the KNN, the interpolation, the int8 bank min/argmin and the OCSVM
steps must match their plain versions exactly (same float32 operations in
the same order, no FMA but the KNN's cross term, written as cuBLAS rounds
it; the int8 product is exact); the bfloat16 bank min/argmin may differ only
where two bank rows tie to float32 summation order, the fused attention
(float32 also by its ex2.approx, about 2 ulp of p) and the bfloat16 probe
product to float32 summation order.
"""

import numpy as np
import pytest
import torch

from cmdiad_tpu_torch import kernels
from cmdiad_tpu_torch.ops import bank_min as bm
from cmdiad_tpu_torch.ops import flash_attn as fa
from cmdiad_tpu_torch.ops import fps
from cmdiad_tpu_torch.ops import int8_dot as i8
from cmdiad_tpu_torch.ops import interpolate as ip
from cmdiad_tpu_torch.ops import knn
from cmdiad_tpu_torch.ops.masked import nonzero_point_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cmdiad_tpu_torch.device import resolve_device
    return resolve_device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _point_sets(rng, b=3, p=2048):
    pts = rng.normal(size=(b, p, 3)).astype(np.float32)
    pts[rng.random((b, p)) < 0.3] = 0.0
    pts[1] = 0.0                                      # all invalid
    g = np.arange(1, 9, dtype=np.float32)
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts[2] = 0.0
    pts[2, 7:7 + len(lattice)] = lattice              # exact distance ties
    return torch.from_numpy(pts)


def test_fps_kernel_matches_plain(dev, rng):
    pts = _point_sets(rng).to(dev)
    mask = nonzero_point_mask(pts)
    before = kernels.LAUNCHES["fps"]
    centers, idx = fps.farthest_point_sample(pts, mask, 300)
    assert kernels.LAUNCHES["fps"] == before + 1
    assert torch.equal(idx, fps._fps_plain(pts, mask, 300))
    assert bool((idx[1] == 0).all())


def _fps_sets(rng, b, p, g):
    """b sets of p points whose first four are, in turn: duplicated points
    (exact distance ties), an all-invalid set, a set with fewer valid
    points than the g centers, and the smoke's disc cloud compacted to p."""
    from cmdiad_tpu_torch.ops.masked import host_compact_points
    pts = rng.normal(size=(b, p, 3)).astype(np.float32)
    pts[rng.random((b, p)) < 0.3] = 0.0
    pts[0, p // 2:] = pts[0, :p - p // 2]            # every point twice
    if b > 1:
        pts[1, :, 2] = 0.0                           # none valid
    if b > 2:
        pts[2, g // 2:] = 0.0                        # g / 2 valid at most
    if b > 3:
        yy, xx = np.mgrid[0:224, 0:224]
        disc = rng.normal(size=(224, 224, 3)).astype(np.float32) * 0.05
        disc[((yy - 112) ** 2 + (xx - 112) ** 2) > 90 ** 2] = 0.0
        pts[3] = host_compact_points(disc, p)
    return torch.from_numpy(pts)


@pytest.mark.parametrize("b", [1, 8, 9])
def test_fps_cluster_kernel_matches_plain_at_full_size(dev, rng, b):
    """Indices equal to the plain version's at the smoke's size (P 32768,
    G 1024), ties, an all-invalid set and G > n_valid among the sets; two
    launches give the same indices."""
    p, g = 32768, 1024
    pts = _fps_sets(rng, b, p, g).to(dev)
    mask = nonzero_point_mask(pts)
    got = fps._fps_cuda(pts, mask, g)
    again = fps._fps_cuda(pts, mask, g)
    want = fps._fps_plain(pts, mask, g)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert fps.cluster_size(b, p) in (8, 16)
    if b > 1:
        assert bool((got[1] == 0).all())


@pytest.mark.parametrize("clusters", [8, 16])
@pytest.mark.parametrize("b,p", [(2, 40000), (2, fps.MAX_POINTS), (9, fps.MAX_POINTS)])
def test_fps_kernel_matches_plain_above_32768_points(dev, rng, b, p, clusters):
    """Both cluster sizes, chosen by the caller, past 32768 points, up to
    MAX_POINTS: clusters of 8 hold 16 points a thread there, clusters of 16
    hold 8 (at B 9 they do not all fit on the card at once).  Indices equal
    the plain version's; two launches give the same indices."""
    g = 512
    pts = _fps_sets(rng, b, p, g).to(dev)
    mask = nonzero_point_mask(pts)
    got = fps._fps_cuda(pts, mask, g, clusters=clusters)
    again = fps._fps_cuda(pts, mask, g, clusters=clusters)
    want = fps._fps_plain(pts, mask, g)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert torch.equal(fps._fps_cuda(pts, mask, g), want)   # the card's choice
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("b", [2, 8])
def test_fps_kernel_matches_plain_on_a_dense_hallucinated_cloud(dev, rng, b):
    """The FtoI rgb-main path: every point of a regressed 224² cloud (P
    50176, all valid) at G 1024, both cluster sizes and the card's choice;
    indices equal the plain version's."""
    p, g = 224 * 224, 1024
    pts = torch.from_numpy(
        0.5 + 0.05 * rng.normal(size=(b, p, 3)).astype(np.float32)).to(dev)
    mask = nonzero_point_mask(pts)
    assert bool(mask.all())
    want = fps._fps_plain(pts, mask, g)
    for clusters in (0, 8, 16):
        assert torch.equal(fps._fps_cuda(pts, mask, g, clusters=clusters), want)


def _surface_parts(rng, b, p=32768):
    """b parts as the benchmark's cells send them: surface-like blobs of
    12k-26k valid points, compacted to a valid prefix of p slots."""
    from perfbench.core.parts import blob, compact
    return torch.from_numpy(np.stack([
        compact(blob(rng, 224, rng.uniform(12000, 26000), i % 2 == 0)[0], p)
        for i in range(b)]))


def _knn_case(rng, case):
    """-> (points (B, P, 3), mask, k) of one KNN case."""
    if case in ("cells_b8", "cells_b1", "k8", "k16"):
        b = {"cells_b8": 8, "cells_b1": 1}.get(case, 2)
        k = {"k8": 8, "k16": 16}.get(case, 128)
        pts = _surface_parts(rng, b)
    elif case == "dense":                        # FtoI rgb main's regressed cloud
        pts = torch.from_numpy(
            0.5 + 0.05 * rng.normal(size=(2, 224 * 224, 3)).astype(np.float32))
        k = 128
    elif case == "fewer_than_k":                 # 100 valid, then none valid
        pts = torch.from_numpy(rng.normal(size=(2, 4096, 3)).astype(np.float32))
        pts[0, 100:] = 0.0
        pts[1] = 0.0
        k = 128
    elif case == "ties":                         # every distance equal
        pts = torch.full((2, 4096, 3), 0.25)
        pts[1, ::3] = 0.0
        k = 128
    elif case == "not_prefix":                   # valid points scattered
        pts = torch.from_numpy(rng.normal(size=(2, 20000, 3)).astype(np.float32))
        pts[torch.from_numpy(rng.random((2, 20000)) < 0.6)] = 0.0
        k = 128
    else:                                        # k up to the kernel's limit
        pts = _surface_parts(rng, 2)
        k = {"k200": 200, "k256": knn.MAX_K}[case]
    return pts, nonzero_point_mask(pts), k


@pytest.mark.parametrize("case", ["cells_b8", "cells_b1", "dense", "k8", "k16",
                                  "fewer_than_k", "ties", "not_prefix", "k200",
                                  "k256"])
def test_knn_kernel_matches_plain(dev, rng, case):
    """masked_knn on the card (one kernel launch) equals _knn_plain on the
    same CUDA tensors, index for index: the cells' shape (B 8 and 1, 12k-26k
    valid of 32768, G 1024 from the FPS kernel), the dense 50176-point
    cloud, small k, fewer valid points than k (the tail takes the first
    valid point; an all-invalid part gives index 0), all-equal distances
    (ties to the lower index), a mask that is not a prefix, and k up to
    MAX_K.  Two launches give the same indices."""
    pts, mask, k = _knn_case(rng, case)
    pts, mask = pts.to(dev), mask.to(dev)
    if case in ("fewer_than_k", "ties", "not_prefix"):
        centers = pts[:, :64] + 0.01
    else:
        centers, _ = fps.farthest_point_sample(pts, mask, 1024)
    before = kernels.LAUNCHES["knn"]
    got = knn.masked_knn(pts, mask, centers, k)
    assert kernels.LAUNCHES["knn"] == before + 1
    want = knn._knn_plain(pts, mask, centers, k)
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(knn.masked_knn(pts, mask, centers, k), got)
    if case == "ties":
        valid = torch.nonzero(mask[1])[:, 0]
        assert torch.equal(got[1], valid[:k].expand_as(got[1]))
    if case == "fewer_than_k":
        assert bool((got[0][:, 100:] == 0).all()) and bool((got[1] == 0).all())


@pytest.mark.parametrize("k", [0, knn.MAX_K + 1, 301])
def test_knn_wrapper_rejects_what_the_kernel_does_not_take(dev, k):
    """k outside 1..min(MAX_K, P) raises before any launch (P 300 here)."""
    pts = torch.ones((1, 300, 3), device=dev)
    before = kernels.LAUNCHES["knn"]
    with pytest.raises(ValueError, match="KNN kernel takes k"):
        knn.masked_knn(pts, nonzero_point_mask(pts), pts[:, :4], k)
    assert kernels.LAUNCHES["knn"] == before


def _interp_inputs(rng, dev, b=2, p=5000, g=256, d=96):
    pts = rng.normal(size=(b, p, 3)).astype(np.float32)
    pts[rng.random((b, p)) < 0.2] = 0.0
    mask = np.all(pts != 0, -1)
    cidx = np.stack([rng.choice(np.flatnonzero(mask[i]), g, replace=False)
                     for i in range(b)])
    centers = np.take_along_axis(pts, cidx[..., None], 1)   # coincident pairs
    feats = rng.normal(size=(b, g, d)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (pts, mask, centers, feats)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interp_kernel_matches_plain(dev, rng, dtype):
    pts, mask, centers, feats = _interp_inputs(rng, dev)
    before = kernels.LAUNCHES["interp"]
    got = ip.three_nn_interpolate(pts, mask, centers, feats, compute_dtype=dtype)
    assert kernels.LAUNCHES["interp"] == before + 1
    want = ip._three_nn_plain(pts, mask, centers, feats, dtype == "bfloat16")
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_bank_min_kernel_matches_plain(dev, rng):
    q = rng.normal(size=(300, 128)).astype(np.float32)
    bank = rng.normal(size=(4096, 128)).astype(np.float32)
    bank[3000] = bank[10]                 # duplicate rows: the first must win
    q[7] = bank[10]
    q, bank = torch.from_numpy(q).to(dev), torch.from_numpy(bank).to(dev)
    before = kernels.LAUNCHES["bank_min"]
    val, idx = bm.bank_min_bf16(q, bank)
    assert kernels.LAUNCHES["bank_min"] == before + 1
    assert int(idx[7]) == 10 and float(val[7]) == 0.0
    qb, bb = q.to(torch.bfloat16), bank.to(torch.bfloat16)
    bnorm = torch.sum(bank * bank, 1)
    kv, ki = bm._bank_min_cuda(qb, bb, bnorm)
    pv, pi = bm._bank_min_plain(qb, bb, bnorm)
    same = ki == pi
    assert float(same.float().mean()) >= 0.99
    torch.testing.assert_close(kv[same], pv[same], rtol=1e-5, atol=1e-3)
    exact = torch.sqrt(torch.sum((q.double() - bank[idx].double()) ** 2, 1))
    torch.testing.assert_close(val.double(), exact, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,nb", [(300, 320), (129, 64), (1000, 4160)])
def test_bank_min_kernel_ties_and_ragged_tiles(dev, rng, nq, nb):
    """Query counts off the 128-query tile and bank rows (64 k) off the
    256-row tile; integer-valued operands, so every float32 sum is exact
    and ties are exact: equal rows in the first and the last bank tile,
    and a zero query whose values are the norms themselves, +0.0 at row 3
    and -0.0 at row 5.  Indices and raw values equal the plain version's
    (the first row of the minimum) and two launches agree bit for bit."""
    d = 128
    q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
    bank = rng.integers(-2, 3, (nb, d)).astype(np.float32)
    bank[nb - 1] = bank[nb // 2] = bank[7]
    q[0] = bank[7]
    bank[3] = bank[5] = 0.0
    q[1] = 0.0
    qb = torch.from_numpy(q).to(dev, torch.bfloat16)
    bb = torch.from_numpy(bank).to(dev, torch.bfloat16)
    bnorm = torch.sum(torch.from_numpy(bank).to(dev) ** 2, 1)
    bnorm[5] = -0.0
    before = kernels.LAUNCHES["bank_min"]
    kv, ki = bm._bank_min_cuda(qb, bb, bnorm)
    kv2, ki2 = bm._bank_min_cuda(qb, bb, bnorm)
    assert kernels.LAUNCHES["bank_min"] == before + 2
    pv, pi = bm._bank_min_plain(qb, bb, bnorm)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.equal(ki, ki2) and torch.equal(kv.view(torch.int32),
                                                kv2.view(torch.int32))
    assert int(ki[0]) == 7 and int(ki[1]) == 3 and float(kv[1]) == 0.0


def test_bank_min_int8_kernel_matches_plain_bit_for_bit(dev, rng):
    """Indices and raw values identical: ties (duplicate rows), bank
    padding rows, an all-zero query and a ragged query count."""
    q = rng.normal(size=(300, 256)).astype(np.float32)
    bank = rng.normal(size=(4096, 256)).astype(np.float32)
    bank[3000] = bank[10]
    bank[1024:1040] = bank[1000]                      # a run of equal rows
    bank[4000:] = 1e6                                 # padding rows
    q[7] = bank[10]
    q[8] = bank[1000]
    q[9] = 0.0
    q, bank = torch.from_numpy(q).to(dev), torch.from_numpy(bank).to(dev)
    before = kernels.LAUNCHES["bank_min_int8"]
    val, idx = bm.bank_min_int8(q, bank)
    assert kernels.LAUNCHES["bank_min_int8"] == before + 1
    assert int(idx[7]) == 10 and int(idx[8]) == 1000 and float(val[7]) == 0.0
    q8, qs = bm.quantize_rows(q)
    b8, bs = bm.quantize_rows(bank)
    bnorm = torch.sum(bank * bank, 1)
    kv, ki = bm._bank_min_int8_cuda(q8, qs, b8, bs, bnorm)
    pv, pi = bm._bank_min_int8_plain(q8, qs, b8, bs, bnorm)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    exact = torch.sqrt(torch.sum((q.double() - bank[idx].double()) ** 2, 1))
    torch.testing.assert_close(val.double(), exact, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,nb", [(129, 64), (300, 320), (1000, 4160)])
def test_bank_min_int8_kernel_ties_and_ragged_tiles(dev, rng, nq, nb):
    """Query counts off the 128-query tile and bank rows (64 k) off the
    256-row tile.  Scales that are powers of two keep every dequantised
    value exact, so ties are exact: equal rows on both sides of each
    256-row tile boundary and in the first and last rows, queries equal to
    such rows (negative values: |b|^2 - 2 b.b), an all-zero query (the
    values are the norms, +0.0 at row 3 and -0.0 at row 5) and far padding
    rows that never win.  Indices and raw values equal the plain version's
    and two launches agree bit for bit."""
    d = 256
    q8 = rng.integers(-3, 4, (nq, d)).astype(np.int8)
    b8 = rng.integers(-3, 4, (nb, d)).astype(np.int8)
    for edge in range(256, nb, 256):
        b8[edge] = b8[edge - 1]                     # a tie across tiles
    b8[nb - 1] = b8[0]
    q8[0] = b8[0]
    q8[2] = b8[min(255, nb - 1)]
    q8[1] = 0
    b8[3] = b8[5] = 0
    pad = nb - nb // 8
    b8[pad:] = 127                                  # bank padding rows
    bscale = np.full(nb, 0.25, np.float32)
    bf = b8.astype(np.float32) * bscale[:, None]
    bnorm = (bf * bf).sum(1).astype(np.float32)
    bnorm[pad:] = 1e12
    bnorm[5] = -0.0
    qscale = np.full(nq, 0.25, np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (q8, qscale, b8, bscale, bnorm)]
    pv, pi = bm._bank_min_int8_plain(*args)
    before = kernels.LAUNCHES["bank_min_int8"]
    kv, ki = bm._bank_min_int8_cuda(*args)
    kv2, ki2 = bm._bank_min_int8_cuda(*args)
    assert kernels.LAUNCHES["bank_min_int8"] == before + 2
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.equal(ki, ki2) and torch.equal(kv.view(torch.int32),
                                                kv2.view(torch.int32))
    assert int(ki[0]) == 0 and float(kv[0]) < 0
    assert int(ki[1]) == 3 and float(kv[1]) == 0.0
    assert bool((ki < pad).all())


def _interp_case(rng, dev, b, p, g, d, empty_tile=False):
    """Disc-like clouds: a fifth of the points masked, centers drawn from
    the valid points (coincident pairs), optionally a whole 256-point tile
    with no valid point, and a run of duplicated points (exact ties)."""
    pts = rng.normal(size=(b, p, 3)).astype(np.float32)
    pts[rng.random((b, p)) < 0.2] = 0.0
    if empty_tile:
        pts[:, 256:512] = 0.0
    pts[:, 600:610] = pts[:, 700:710]
    mask = np.all(pts != 0, -1)
    cidx = np.stack([rng.choice(np.flatnonzero(mask[i]), g, replace=False)
                     for i in range(b)])
    centers = np.take_along_axis(pts, cidx[..., None], 1)
    feats = rng.normal(size=(b, g, d)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (pts, mask, centers, feats)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,p,g,d,empty_tile", [
    (2, 1000, 3, 96, False),          # P off the tile, the fewest centers
    (2, 2600, 1024, 136, True),       # a tile with no valid point, D off 128
    (2, 50176, 1024, 768, False),     # the paths' full width
])
def test_interp_kernel_is_bit_identical_to_plain(dev, rng, dtype, b, p, g, d,
                                                 empty_tile):
    """Every output bit equal to the plain version's, in both output types,
    and over two launches."""
    pts, mask, centers, feats = _interp_case(rng, dev, b, p, g, d, empty_tile)
    bf16 = dtype == "bfloat16"
    want = ip._three_nn_plain(pts, mask, centers, feats, bf16)
    bits = torch.int16 if bf16 else torch.int32
    got = ip._three_nn_cuda(pts, mask, centers, feats, bf16)
    again = ip._three_nn_cuda(pts, mask, centers, feats, bf16)
    assert got.dtype == want.dtype
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(got.view(bits), again.view(bits))
    if empty_tile:
        assert bool((got[:, 256:512] == 0).all())


def _qkv(rng, dev, dtype, b=2, n=135, h=3):
    """q, k, v as the backbones hand them over: strided views of one
    (B, N, 3, H, 64) projection."""
    x = torch.from_numpy(rng.normal(size=(b, n, 3, h, 64)).astype(np.float32))
    x = x.to(dev, dtype)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


@pytest.mark.parametrize("n,b,h", [(64, 2, 3), (135, 2, 3), (785, 2, 3),
                                   (1024, 2, 3), (785, 8, 12), (1024, 8, 6),
                                   (1370, 8, 12), (1025, 8, 6), (1374, 8, 16),
                                   (785, 1, 12), (1024, 1, 6)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_kernel_matches_plain(dev, rng, dtype, n, b, h):
    """float32: summation order and ex2.approx's 2 ulp of p.  bfloat16: the
    same rounding points, so an element differs where a float32 sum rounds
    to the other bfloat16 neighbour: one output ulp (2^-7 relative) plus a
    p ulp.  The backbones' shapes (B 8, ViT 12 heads x 785, Point-MAE 6 x
    1024) take the two CTA shapes of the bfloat16 kernel, as do DINOv2 at
    518² (12 x 1370) and Point-BERT (6 x 1025 with its cls token), whose key
    tiles end ragged; in float32 DINOv2 ViT-L/14-reg4 (16 x 1374) and DINOv2 at 518² take
    128 queries a CTA, the rest 64 with each tile's keys split between two
    warps; two launches agree bit for bit."""
    q, k, v = _qkv(rng, dev, dtype, b=b, n=n, h=h)
    before = kernels.LAUNCHES["flash_attn"]
    got = fa.fused_attention(q, k, v, 0.125, use_flash=True)
    again = fa.fused_attention(q, k, v, 0.125, use_flash=True)
    assert kernels.LAUNCHES["flash_attn"] == before + 2
    assert torch.equal(got, again)
    want = fa._fused_attention_plain(q, k, v, 0.125)
    assert got.dtype == dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-3)
        assert float((got - want).abs().mean()) <= 2 ** -8 * float(want.abs().mean())
    # contiguous operands take the same path
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    assert torch.equal(fa.fused_attention(qc, kc, vc, 0.125, use_flash=True).float(),
                       got)


def test_float32_attention_takes_the_kernel_without_use_flash(dev, rng):
    """float32 at head dim 64 on the card launches the kernel whatever
    use_flash says, once a call, within 1e-5 of the einsum form (summation
    order and ex2.approx against expf), and counts no score bytes."""
    from cmdiad_tpu_torch import tracing
    q, k, v = _qkv(rng, dev, torch.float32, b=2, n=785, h=3)
    before = kernels.LAUNCHES["flash_attn"]
    tracing.reset_counters()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.predict_call(2):
            got = fa.fused_attention(q, k, v, 0.125, use_flash=False,
                                     score_counter="scores")
    assert kernels.LAUNCHES["flash_attn"] == before + 1
    assert tracing.counters()["scores"] == 0
    tracing.reset_counters()
    torch.testing.assert_close(got, fa._einsum_attention(q, k, v, 0.125),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["head_dim_32", "bfloat16", "requires_grad"])
def test_attention_outside_the_float32_route_keeps_the_einsum_form(dev, rng, case):
    d, dtype = (32, torch.float32) if case == "head_dim_32" else (
        64, torch.bfloat16 if case == "bfloat16" else torch.float32)
    x = torch.from_numpy(rng.normal(size=(2, 135, 3, 3, d)).astype(np.float32))
    x = x.to(dev, dtype).requires_grad_(case == "requires_grad")
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = kernels.LAUNCHES["flash_attn"]
    got = fa.fused_attention(q, k, v, 0.125, use_flash=False)
    assert kernels.LAUNCHES["flash_attn"] == before
    assert torch.equal(got, fa._einsum_attention(q, k, v, 0.125))
    assert got.requires_grad == (case == "requires_grad")


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (1024, 768, 2048),
                                   (192, 256, 320), (8192, 768, 8192)])
def test_int8_dot_kernel_matches_plain(dev, rng, m, k, n):
    """int8 exact, bfloat16 to float32 summation order, at tile-sized and
    ragged (M, N not multiples of 128 x 256) shapes; two launches equal."""
    a = torch.from_numpy(rng.integers(-127, 127, (m, k)).astype(np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-127, 127, (n, k)).astype(np.int8)).to(dev)
    before = kernels.LAUNCHES["int8_dot"]
    got = i8.int8_dot(a, b)
    assert kernels.LAUNCHES["int8_dot"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, i8._int8_dot_plain(a, b))
    assert torch.equal(i8.int8_dot(a, b), got)
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got = i8.int8_dot(ab, bb)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, i8._int8_dot_plain(ab, bb), rtol=1e-6,
                               atol=1e-6 * k * 127 * 127)
    assert torch.equal(i8.int8_dot(ab, bb), got)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((4, 96), device=dev)            # width not a multiple of 64
    with pytest.raises(ValueError, match="width"):
        bm.bank_min_bf16(q, torch.zeros((64, 96), device=dev))
    q = torch.zeros((4, 192), device=dev)           # nor of 128 (int8)
    with pytest.raises(ValueError, match="width"):
        bm.bank_min_int8(q, torch.zeros((64, 192), device=dev))
    pts = torch.ones((1, fps.MAX_POINTS + 4464, 3), device=dev)  # 70000: too many
    with pytest.raises(ValueError, match="at most"):
        fps.farthest_point_sample(pts, nonzero_point_mask(pts), 4)
    pts = torch.ones((1, 64, 3), device=dev)
    with pytest.raises(ValueError, match="clusters of 8 or 16"):
        fps._fps_cuda(pts, nonzero_point_mask(pts), 4, clusters=4)
    x = torch.zeros((1, 8, 2, 32), device=dev)      # head dim 32
    with pytest.raises(ValueError, match="head dim"):
        fa.fused_attention(x, x, x, 0.1, use_flash=True)
    x = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.fused_attention(x, x, x, 0.1, use_flash=True)
    x = torch.zeros((1, fa.MAX_TOKENS_BF16 + 1, 2, 64), device=dev,
                    dtype=torch.bfloat16)                # K no longer fits
    with pytest.raises(ValueError, match="at most"):
        fa.fused_attention(x, x, x, 0.1, use_flash=True)
    pts = torch.ones((1, 16, 3), device=dev)        # feature width 12
    with pytest.raises(ValueError, match="width"):
        ip.three_nn_interpolate(pts, nonzero_point_mask(pts), pts[:, :4],
                                torch.zeros((1, 4, 12), device=dev))
    a = torch.zeros((100, 128), device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="% 64"):
        i8.int8_dot(a, torch.zeros((64, 128), device=dev, dtype=torch.int8))


# float32 attention at head dim 64 (both small backbones) takes the kernel
# on every path
DETECTION_KERNELS = {"": ("bank_min", "flash_attn", "fps", "interp", "knn"),
                     "throughput": ("bank_min_int8", "flash_attn", "fps", "interp", "knn")}


@pytest.mark.parametrize("path", ["", "throughput"])
def test_small_double_method_on_the_card(dev, path):
    """fit + evaluate through the entry points at a small width (head dim
    64, bank widths multiples of 128), the path's kernels launched, the
    card's predictions equal to the CPU's within the quantised selection's
    near-tie envelope (float32 backbones) or within the bfloat16
    backbones' resolution (the throughput configuration)."""
    import os
    import tempfile
    from cmdiad_tpu_torch.config import Config
    from cmdiad_tpu_torch.data.loader import stack_batches
    from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
    from cmdiad_tpu_torch.methods.registry import build_method
    from cmdiad_tpu_torch.models.backbone import DualBackbone
    from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
    from cmdiad_tpu_torch.models.vit import ViTConfig
    from cmdiad_tpu_torch.runner import CMDIADRunner

    size = 64
    extra = (dict(compute_dtype="bfloat16", dist_method_s="l2_int8",
                  use_flash=True) if path else {})
    cfg = Config(rgb_size=size, xyz_size=size, gt_size=size, f_coreset=0.5,
                 batch_size=3, **extra)
    train, test = make_synthetic_samples(n_train=5, size=size,
                                         anomaly_radius=(0.13, 0.18))

    def backbone(device):
        return DualBackbone(
            vit_config=ViTConfig(img_size=size, embed_dim=128, depth=2, num_heads=2),
            pm_config=PointMAEConfig(num_group=32, group_size=16, encoder_dims=128,
                                     trans_dim=128, depth=2, num_heads=2,
                                     fetch_idx=(0, 1)),
            compute_dtype=cfg.compute_dtype, use_flash=cfg.use_flash,
            device=device)

    kernels.reset_launches()
    runner = CMDIADRunner(cfg, backbone=backbone(dev), device=dev)
    runner.fit("widget", train)
    metrics = runner.evaluate("widget", test)
    used = {k for k, n in kernels.LAUNCHES.items() if n > 0}
    assert used == set(DETECTION_KERNELS[path]), kernels.LAUNCHES
    assert all(0.0 <= v <= 1.0 for v in metrics.values()), metrics
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        runner.method.save_state(path)
        cpu = build_method(cfg, backbone=backbone("cpu"), device="cpu")
        cpu.load_state(path)
    for batch in stack_batches(test, 3):
        cpu.predict_batch(batch)
    maps_gpu = np.stack(runner.method.predictions)
    maps_cpu = np.stack(cpu.predictions)
    scale = np.abs(maps_cpu).max()
    # bfloat16 backbones: the two devices round their GEMM sums apart, so
    # features differ by a few bfloat16 ulps (2^-8) and the maps with them
    tol = (1e-4, 2e-2, 1e-3) if not path else (2e-2, 5e-2, 1e-2)
    np.testing.assert_allclose(cpu.image_preds, runner.method.image_preds,
                               rtol=tol[0])
    assert np.abs(maps_gpu - maps_cpu).max() <= tol[1] * scale
    assert np.abs(maps_gpu - maps_cpu).mean() <= tol[2] * scale


MTFI_KERNELS = {"mtfi_ftof_xyz_main": {"bank_min", "flash_attn", "fps", "interp", "knn"},
                "mtfi_itof_rgb_main": {"bank_min", "flash_attn"}}


@pytest.mark.parametrize("preset", list(MTFI_KERNELS))
def test_small_mtfi_method_on_the_card(dev, preset):
    """An MTFI preset at a small width (head dim 64, bank widths multiples
    of 128): fit on both modalities, evaluate on the main one alone, only
    the main path's kernels launched while evaluating; the CPU serving the
    card's fitted state with a CPU copy of the same fusion net predicts the
    same within the near-tie envelope of test_small_double_method_on_the_card."""
    import copy
    import os
    import tempfile
    from cmdiad_tpu_torch.config import method_preset
    from cmdiad_tpu_torch.data.loader import stack_batches
    from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
    from cmdiad_tpu_torch.methods.registry import build_method
    from cmdiad_tpu_torch.models.backbone import DualBackbone
    from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
    from cmdiad_tpu_torch.models.vit import ViTConfig
    from cmdiad_tpu_torch.runner import CMDIADRunner

    size = 64
    cfg = method_preset(preset, rgb_size=size, xyz_size=size, gt_size=size,
                        f_coreset=0.5, batch_size=3)
    train, test = make_synthetic_samples(n_train=5, size=size,
                                         anomaly_radius=(0.13, 0.18))
    keep = (("rgb",) if cfg.main_modality == "rgb"
            else ("organized_pc", "points_compact")) + ("gt", "label", "rgb_path")
    test = [{k: v for k, v in s.items() if k in keep} for s in test]

    def backbone(device):
        return DualBackbone(
            vit_config=ViTConfig(img_size=size, embed_dim=128, depth=2, num_heads=2),
            pm_config=PointMAEConfig(num_group=32, group_size=16, encoder_dims=128,
                                     trans_dim=128, depth=2, num_heads=2,
                                     fetch_idx=(0, 1)),
            device=device)

    runner = CMDIADRunner(cfg, backbone=backbone(dev), device=dev)
    runner.fit("widget", train)
    kernels.reset_launches()
    metrics = runner.evaluate("widget", test)
    used = {k for k, n in kernels.LAUNCHES.items() if n > 0}
    assert used == MTFI_KERNELS[preset], kernels.LAUNCHES
    assert all(0.0 <= v <= 1.0 for v in metrics.values()), metrics
    assert set(runner.method.banks) == {cfg.main_modality, "fusion"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        runner.method.save_state(path)
        cpu = build_method(cfg, backbone=backbone("cpu"), device="cpu",
                           fusion=copy.deepcopy(runner.method.fusion).to("cpu"))
        cpu.load_state(path)
    for batch in stack_batches(test, 3):
        cpu.predict_batch(batch)
    maps_gpu = np.stack(runner.method.predictions)
    maps_cpu = np.stack(cpu.predictions)
    scale = np.abs(maps_cpu).max()
    np.testing.assert_allclose(cpu.image_preds, runner.method.image_preds, rtol=1e-4)
    assert np.abs(maps_gpu - maps_cpu).max() <= 2e-2 * scale
    assert np.abs(maps_gpu - maps_cpu).mean() <= 1e-3 * scale


# train method -> its batch's shapes at full width (768-wide features,
# 3136 tokens, 224² images)
_TRAIN_SHAPES = {
    "HallucinationCrossModality": {"patch": (3136, 1536)},
    "HallucinationCrossModalityConv": {"patch": (3136, 1536)},
    "RGBFeatureToXYZInputMLP": {"feature": (3136, 768), "target": (224, 224, 3)},
    "XYZFeatureToRGBInputMLP": {"feature": (3136, 768), "target": (224, 224, 3)},
    "RGBFeatureToXYZInputConv": {"feature": (3136, 768), "target": (224, 224, 3)},
    "XYZFeatureToRGBInputConv": {"feature": (3136, 768), "target": (224, 224, 3)},
    "RGBInputToXYZFeatureHRNET": {"image": (224, 224, 3), "feature": (3136, 768)},
    "XYZInputToRGBFeatureHRNET": {"image": (224, 224, 3), "feature": (3136, 768)},
}


def _leaf_err(got, want):
    return max(float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 1e-30)
               for k, w in want.items())


@pytest.mark.parametrize("tm", list(_TRAIN_SHAPES))
def test_training_step_on_the_card_matches_the_cpu(dev, rng, tm):
    """One training step (batch 2, full width, seeded weights, lr > 0 from
    the first update) on the card and on the CPU, at ``chip_smoke.py``
    phase 7's limits: the loss to rtol 1e-4 and the BatchNorm statistics to
    1e-4 of each leaf's largest in float32; the updated parameters to 1e-4
    of each leaf's largest in float64 (float32 keeps about two digits of
    some BatchNorm gradients on either device)."""
    from cmdiad_tpu_torch.config import TrainConfig
    from cmdiad_tpu_torch.models import names
    from cmdiad_tpu_torch.train.checkpoint import flatten
    from cmdiad_tpu_torch.train.distill import DistillTrainer

    arrays = {k: rng.normal(size=(2, *s)).astype(np.float32)
              for k, s in _TRAIN_SHAPES[tm].items()}
    cfg = TrainConfig(train_method=tm, batch_size=2, warmup_epochs=0, output_dir="")
    for dtype in (torch.float32, torch.float64):
        out = {}
        for d in (dev, "cpu"):
            t = DistillTrainer(cfg, arrays=arrays, test_arrays=arrays, device=d)
            if dtype == torch.float64:
                t.net.double()
                t.net.dtype = torch.float64
                for state in (t.opt.mu, t.opt.nu):
                    for k in state:
                        state[k] = state[k].double()
            loss, _ = t.step({k: torch.from_numpy(v).to(d, dtype) for k, v in arrays.items()})
            out[d] = (float(loss), flatten(names.to_flax(t.table, t.net.state_dict())))
        (card_loss, card), (cpu_loss, cpu) = out[dev], out["cpu"]
        assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss), (dtype, card_loss, cpu_loss)
        stats = {k: v for k, v in cpu.items() if k.startswith("batch_stats")}
        if dtype == torch.float32 and stats:
            assert _leaf_err(card, stats) <= 1e-4
        if dtype == torch.float64:
            assert _leaf_err(card, {k: v for k, v in cpu.items()
                                    if k.startswith("params")}) <= 1e-4


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_sharded_bank_min_on_the_card(dev, rng, backend, world):
    """The bank-min kernels on each rank's shard (NCCL with one rank, gloo
    with two ranks on the one card): one launch a metric a rank, on the
    shard's rows; the same answer on every rank; at world 1 the one-device
    result bit for bit, at world 2 the exact distance of the chosen row,
    never above the one-device choice's."""
    from cmdiad_tpu_torch.parallel.launch import spawn
    import torch_parallel_workers as workers
    bank = rng.normal(size=(4096, 768)).astype(np.float32)
    bank[10 + 2048] = bank[10]                 # a duplicate on the second shard
    q = rng.normal(size=(300, 768)).astype(np.float32)
    q[7] = bank[10]
    got = spawn(workers.sharded_min_launches, world, backend, ["cuda:0"] * world,
                args=(bank, q, ("l2", "l2_int8")))
    tb, tq = torch.from_numpy(bank).to(dev), torch.from_numpy(q).to(dev)
    for m, fn in (("l2", bm.bank_min_bf16), ("l2_int8", bm.bank_min_int8)):
        want_v, want_i = (t.cpu().numpy() for t in fn(tq, tb))
        kernel = "bank_min" if m == "l2" else "bank_min_int8"
        for res in got:
            v, i, seen = res[m]
            assert seen == [(kernel, 4096 // world)], seen
            np.testing.assert_array_equal(v, got[0][m][0])
            np.testing.assert_array_equal(i, got[0][m][1])
        v, i, _ = got[0][m]
        assert i[7] == 10 and v[7] == 0.0
        if world == 1:
            np.testing.assert_array_equal(v, want_v)
            np.testing.assert_array_equal(i, want_i)
        else:
            exact = np.sqrt(((q.astype(np.float64) - bank[i]) ** 2).sum(1))
            np.testing.assert_allclose(v, exact, rtol=1e-5, atol=1e-5)
            assert np.all(v <= want_v + 1e-6)


# --------------------------------------------------------------- the tail --

def _scan(rng, size=200, pitch=5e-4):
    """An organized scan: a tilted background plane, a raised disc and a
    separate tuft, a few invalid pixels (float32 (size, size, 3))."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    x, y = (xx - size / 2) * pitch, (yy - size / 2) * pitch
    z = 0.5 + 0.05 * x + 0.03 * y
    r2 = (xx - size / 2) ** 2 + (yy - size / 2) ** 2
    z -= np.where(r2 < (size / 3) ** 2, 0.01, 0.0)
    z -= np.where((yy - size / 6) ** 2 + (xx - 5 * size / 6) ** 2 < 16, 0.02, 0.0)
    pc = np.stack([x, y, z], -1) + rng.normal(0, 5e-5, (size, size, 3))
    pc[rng.random((size, size)) < 0.02] = 0
    return pc.astype(np.float32)


@pytest.mark.parametrize("scene", ["scan", "blobs", "noise", "shared", "duplicates"])
def test_dbscan_kernel_matches_plain(dev, rng, scene):
    """The kernel's roots and neighbour counts equal the plain version's:
    the same float64 eps test, the smallest core index as the root."""
    from cmdiad_tpu_torch.preprocess import cluster
    eps, min_points = 0.006, 30
    if scene == "scan":
        pts = _scan(rng).reshape(-1, 3)
        pts = pts[(pts != 0).all(1)]
        eps = 0.003
    elif scene == "blobs":
        pts = np.concatenate([rng.normal(c, 0.003, (400, 3)) for c in (0.0, 0.02, 0.04)]
                             + [rng.uniform(-0.02, 0.06, (300, 3))])
        min_points = 12
    elif scene == "noise":
        pts = rng.uniform(0, 1, (2000, 3))
    elif scene == "shared":
        pts = np.concatenate([rng.normal(0, 5e-4, (40, 3)) + [0.005, 0, 0],
                              [[0.0, 0.0, 0.0015]],
                              rng.normal(0, 5e-4, (40, 3)) + [-0.005, 0, 0]])
        eps, min_points = 0.0045, 20
    else:
        base = rng.normal(0, 0.004, (500, 3))
        pts = np.concatenate([base, base[::-1], base[:50]])     # exact duplicates
    p = torch.from_numpy(np.ascontiguousarray(pts, np.float32))
    before = kernels.LAUNCHES["dbscan"]
    root, count = cluster._roots_cuda(p.to(dev), eps, min_points)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dbscan"] == before + 1
    want_root, want_count = cluster._roots_plain(p.to(dev), eps, min_points)
    assert torch.equal(count, want_count)
    assert torch.equal(root, want_root)
    assert torch.equal(cluster.dbscan_labels(p.to(dev), eps, min_points),
                       cluster._rank(want_root))


def test_preprocess_sample_on_the_card_launches_dbscan(dev, rng, tmp_path):
    """No fallback: a sample preprocessed on the card launches the DBSCAN
    kernel once, and gives the CPU's arrays."""
    from cmdiad_tpu_torch.data import png, tiffio
    from cmdiad_tpu_torch.preprocess import mvtec
    pc = _scan(rng, size=100, pitch=1e-3)
    rgb = rng.integers(0, 256, (100, 100, 3)).astype(np.uint8)
    paths = {}
    for tag in ("card", "cpu"):
        for sub in ("xyz", "rgb", "gt"):
            (tmp_path / tag / sub).mkdir(parents=True)
        tiffio.imwrite(str(tmp_path / tag / "xyz" / "s.tiff"), pc)
        png.imwrite(tmp_path / tag / "rgb" / "s.png", rgb)
        png.imwrite(tmp_path / tag / "gt" / "s.png", (rgb[..., 0] > 128).astype(np.uint8) * 255)
        paths[tag] = str(tmp_path / tag / "xyz" / "s.tiff")
    kernels.reset_launches()
    card = mvtec.preprocess_sample(paths["card"], device=dev)
    assert kernels.LAUNCHES["dbscan"] == 1
    cpu = mvtec.preprocess_sample(paths["cpu"], device="cpu")
    assert card["n_clusters"] == cpu["n_clusters"] == 2
    for k in ("pc", "rgb", "gt"):
        assert np.array_equal(card[k], cpu[k]), k


def test_quantized_blur_on_the_card_is_bit_equal(dev, rng):
    from cmdiad_tpu_torch.ops import blur
    maps = np.abs(rng.normal(size=(8, 224, 224))).astype(np.float32)
    maps[1] = 0.0
    t = torch.from_numpy(maps)
    assert torch.equal(blur.quantized_knn_gaussian_blur(t.to(dev)).cpu(),
                       blur.quantized_knn_gaussian_blur(t))


def test_pinned_uploads_in_flight_equal_blocking_uploads(dev, rng, monkeypatch):
    """Back-to-back ``add_batch_to_mem_bank`` and ``predict_batch`` calls
    over distinct batches at full width, queued behind a sleeping stream so
    that every part's pinned block is still waiting for its copy when the
    host stages the next one, with no host read between the bank calls, and
    planar images among the parts: the banks and the predictions are those
    of the same calls with blocking uploads, a planar image keeping its
    strides.  The quantized blur still divides by the tensor 255
    that stays on the card, and gives the CPU's bits."""
    from cmdiad_tpu_torch import tracing
    from cmdiad_tpu_torch.ops import blur
    from test_torch_tracing import _batch, _method

    method = _method("dual", dev, 8192)
    bank_batches = [_batch(8, 8, 224, 32768, seed=s) for s in (10, 11, 12, 13)]
    predict_batches = [_batch(8, n, 224, 32768, seed=s) for n, s in ((8, 14), (8, 15), (5, 16))]
    for b in (bank_batches[1], predict_batches[1]):     # planar, as a resized image is
        b["rgb"] = np.ascontiguousarray(b["rgb"].transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    planar = bank_batches[1]["rgb"]
    assert tracing.stage(planar, dev).stride() == torch.as_tensor(planar, device=dev).stride()

    def run():
        method._bank_acc = {n: [] for n in method.bank_names}
        method.reset_predictions()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 31)                       # about a second of a busy stream
        for b in bank_batches:
            method.add_batch_to_mem_bank(b, "widget")
        for b in predict_batches:
            torch.cuda._sleep(1 << 29)
            method.predict_batch(b)
        banks = {n: torch.cat(rows).cpu() for n, rows in method._bank_acc.items()}
        return banks, list(method.image_preds), [p.copy() for p in method.predictions]

    staged = run()
    monkeypatch.setattr(tracing, "stage", lambda x, device: torch.as_tensor(
        np.asarray(x), device=device))
    blocking = run()
    monkeypatch.undo()
    assert staged[0].keys() == blocking[0].keys()
    assert {n: len(rows) for n, rows in staged[0].items()} == {"xyz": 4 * 8 * 56 * 56,
                                                                "rgb": 4 * 8 * 28 * 28}
    for n in staged[0]:
        assert torch.equal(staged[0][n], blocking[0][n]), n
    assert len(staged[1]) == 21 and staged[1] == blocking[1]
    assert all(np.array_equal(a, b) for a, b in zip(staged[2], blocking[2]))

    asked = []
    real = tracing.constant
    monkeypatch.setattr(tracing, "constant", lambda device, dtype, build, *args: asked.append(
        (build, args)) or real(device, dtype, build, *args))
    maps = torch.from_numpy(np.abs(rng.normal(size=(8, 224, 224))).astype(np.float32))
    got = blur.quantized_knn_gaussian_blur(maps.to(dev))
    assert (float, (255.0,)) in asked
    div = real(dev, torch.float32, float, 255.0)
    assert isinstance(div, torch.Tensor) and div.device.type == "cuda" and div.dim() == 0
    assert div.dtype == torch.float32 and float(div) == 255.0
    assert torch.equal(got.cpu(), blur.quantized_knn_gaussian_blur(maps))


def test_jax_fitter_on_the_card_matches_the_cpu(dev, rng, monkeypatch):
    """The float32 steps of the kernel and of its plain version: the same
    bits, over several launches (a launch of two epochs, then one)."""
    from cmdiad_tpu_torch.fusion import ocsvm
    x = np.abs(rng.normal(size=(20000, 2))) * [0.01, 0.02]
    before = kernels.LAUNCHES["ocsvm_sgd"]
    monkeypatch.setattr(ocsvm, "LAUNCH_ROWS", 40000)
    w, rho = ocsvm._fit_jax(x, 0.5, 3, 42, dev)
    assert kernels.LAUNCHES["ocsvm_sgd"] == before + 2
    monkeypatch.undo()
    w_cpu, rho_cpu = ocsvm._fit_jax(x, 0.5, 3, 42, "cpu")
    assert np.array_equal(w, w_cpu) and rho == rho_cpu


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("t_start", [1, 2 ** 24 - 1500])
def test_ocsvm_sgd_kernel_matches_plain(dev, rng, d, t_start):
    """Steps in tiles of 1024 and a ragged last tile, from a state in mid
    fit; from t = 2^24 - 1500 the counter stops at 2^24 after 1500 of the
    3000 steps, and the step size with it."""
    from cmdiad_tpu_torch.fusion import ocsvm
    rows = torch.from_numpy((np.abs(rng.normal(size=(3000, d))) * 0.5).astype(np.float32))
    state = torch.zeros(ocsvm.STATE, dtype=torch.float32)
    state[:d] = torch.from_numpy(rng.uniform(0.1, 1.0, d).astype(np.float32))
    state[ocsvm.MAX_D] = 0.3
    state[ocsvm.MAX_D + 1] = float(t_start)
    args = (np.float32(0.25), np.float32(1.7), np.float32(0.5))
    card = state.to(dev)
    for part in (rows[:2500], rows[2500:]):          # two launches, the state between
        ocsvm.sgd_steps(part.to(dev), card, *args)
        ocsvm.sgd_steps(part, state, *args)
    assert torch.equal(card.cpu(), state)
    assert float(state[ocsvm.MAX_D + 1]) == min(t_start + 3000, 2 ** 24)


def test_eyecandies_projection_on_the_card_equals_the_cpu(dev, rng, tmp_path):
    """Elementwise float64 on both devices: the same bits."""
    from cmdiad_tpu_torch.data import png
    from cmdiad_tpu_torch.preprocess import eyecandies
    d = tmp_path / "s"
    d.mkdir()
    depth = (rng.uniform(0.3, 0.9, (512, 512)) * 65535).astype(np.uint16)
    png.imwrite_grey16(d / "000_depth.png", depth)
    (d / "000_info_depth.yaml").write_text("normalization:\n  max: 1.5\n  min: 0.5\n")
    np.savetxt(d / "000_pose.txt", np.eye(4))
    out = {}
    for device in (dev, "cpu"):
        out[str(device)] = eyecandies.convert_sample(d, "000", tmp_path / f"{device}.tiff",
                                                     device=device)
    a, b = out.values()
    assert a.shape == (512, 512, 3) and np.array_equal(a, b)
    assert png.imread_grey16(d / "000_depth.png").dtype == np.uint16
