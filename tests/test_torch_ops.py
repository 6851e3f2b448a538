"""The port's plain ops against their JAX-package counterparts on CPU.

Inputs are made with numpy from a seed and go through both functions.
Tolerances: float32 paths that differ only in summation order are held to
about 1e-5 relative; selections (argmin, top-k, greedy picks) must agree
exactly on data without near-ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cmdiad_tpu.ops import blur as jblur
from cmdiad_tpu.ops import coreset as jcore
from cmdiad_tpu.ops import knn as jknn
from cmdiad_tpu.ops import masked as jmasked
from cmdiad_tpu.ops import pooling as jpool
from cmdiad_tpu.ops import scoring as jscore
from cmdiad_tpu_torch.ops import blur, coreset, knn, masked, pooling, scoring

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- masked ---

def test_masked_ops_match(rng):
    pts = rng.normal(size=(3, 200, 3)).astype(np.float32)
    pts[rng.random((3, 200)) < 0.4] = 0.0
    pts[0, :5, 1] = 0.0             # one zero coordinate makes a point invalid
    pts[2] = 0.0
    mask = masked.nonzero_point_mask(_t(pts))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmasked.nonzero_point_mask(jnp.asarray(pts))))
    assert not mask[0, :5].any()
    np.testing.assert_array_equal(masked.first_valid_index(mask).numpy(),
                                  np.asarray(jmasked.first_valid_index(jnp.asarray(mask.numpy()))))
    for cap in (64, 150):
        got = masked.compact_points(_t(pts), mask, cap).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmasked.compact_points(
            jnp.asarray(pts), jnp.asarray(mask.numpy()), cap)))
        for i in range(3):
            np.testing.assert_array_equal(
                masked.host_compact_points(pts[i], cap), got[i])


# ---------------------------------------------------------------- knn ---

def test_pairwise_sqdist_is_clamped(rng):
    a = rng.normal(size=(50, 3)).astype(np.float32) * 100
    d = knn.pairwise_sqdist(_t(a), _t(a)).numpy()
    assert d.min() >= 0.0
    np.testing.assert_allclose(d, np.asarray(jknn.pairwise_sqdist(jnp.asarray(a), jnp.asarray(a))),
                               rtol=1e-5, atol=1e-2)


def test_masked_knn_matches_exact_jax(rng):
    """Exact KNN: same neighbours in the same order (ties by lower index),
    and the fewer-than-k tail substituted with the first valid point."""
    pts = rng.normal(size=(2, 300, 3)).astype(np.float32)
    pts[rng.random((2, 300)) < 0.3] = 0.0
    pts[1, 10:] = 0.0               # 10 slots, 9 of them valid after this:
    pts[1, 3] = 0.0                 # fewer than k
    mask = np.all(pts != 0, -1)
    centers = np.stack([pts[i, np.flatnonzero(mask[i])[:6]] for i in range(2)])
    got = knn.masked_knn(_t(pts), _t(mask), _t(centers), 16).numpy()
    want = np.asarray(jknn.masked_knn(jnp.asarray(pts), jnp.asarray(mask),
                                      jnp.asarray(centers), 16, method="exact"))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[1][:, 9:] == np.flatnonzero(mask[1])[0])


def test_masked_knn_ties_take_lower_index():
    pts = np.zeros((1, 8, 3), np.float32)
    pts[0, :, :] = 1.0
    pts[0, :, 0] = [5, 2, 4, 2, 3, 4, 2, 5]     # squared distances to x=3:
    #                4, 1, 1, 1, 0, 1, 1, 4
    centers = np.array([[[3.0, 1.0, 1.0]]], np.float32)
    mask = np.ones((1, 8), bool)
    got = knn.masked_knn(_t(pts), _t(mask), _t(centers), 8).numpy()[0, 0]
    np.testing.assert_array_equal(got, [4, 1, 2, 3, 5, 6, 0, 7])
    np.testing.assert_array_equal(got, np.asarray(jknn.masked_knn(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers), 8,
        method="exact"))[0, 0])


# ------------------------------------------------------ pooling / blur ---

@pytest.mark.parametrize("fn,out", [("adaptive_avg_pool", 7), ("bilinear_resize", 40),
                                    ("avg3x3_then_adaptive_pool", 5)])
def test_pooling_matches(rng, fn, out):
    x = rng.normal(size=(2, 17, 13, 4)).astype(np.float32)
    got = getattr(pooling, fn)(_t(x), out).numpy()
    want = np.asarray(getattr(jpool, fn)(jnp.asarray(x), out))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pooling_matches_torch_semantics(rng):
    x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    xt = _t(x).permute(0, 3, 1, 2)
    want = torch.nn.functional.interpolate(xt, size=(40, 40), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(pooling.bilinear_resize(_t(x), 40), want,
                               rtol=1e-5, atol=1e-5)
    want = torch.nn.functional.adaptive_avg_pool2d(
        torch.nn.functional.avg_pool2d(xt, 3, stride=1), 5).permute(0, 2, 3, 1)
    torch.testing.assert_close(pooling.avg3x3_then_adaptive_pool(_t(x), 5), want,
                               rtol=1e-5, atol=1e-5)


def test_blur_matches(rng):
    maps = rng.random((3, 32, 32)).astype(np.float32)
    maps[1] = 0.0                   # zero map: the max-normalisation guard
    got = blur.knn_gaussian_blur(_t(maps)).numpy()
    want = np.stack([np.asarray(jblur.knn_gaussian_blur(jnp.asarray(m))) for m in maps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ scoring ---

@pytest.mark.parametrize("metric", ["l2", "l1", "cos_dist"])
def test_cdist_and_exact_bank_min_match(rng, metric):
    a = rng.normal(size=(40, 16)).astype(np.float32)
    b = rng.normal(size=(300, 16)).astype(np.float32)
    np.testing.assert_allclose(scoring.cdist(_t(a), _t(b), metric).numpy(),
                               np.asarray(jscore.cdist(jnp.asarray(a), jnp.asarray(b), metric)),
                               rtol=1e-5, atol=1e-5)
    padded = scoring.pad_bank(_t(b), bucket=128)
    assert padded.shape == (384, 16) and float(padded[-1, 0]) == scoring.PAD_VALUE
    v, i = scoring.bank_min_dist(_t(a), padded, metric, chunk=100, n_valid=300)
    jv, ji = jscore.bank_min_dist(jnp.asarray(a), jnp.asarray(padded.numpy()), metric,
                                  chunk=128, n_valid=300)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cos_dist"])
def test_bank_nn_table_matches(rng, metric):
    bank = rng.normal(size=(200, 8)).astype(np.float32)
    bank[150] = bank[20]            # duplicate: each finds the other second
    padded = scoring.pad_bank(_t(bank), bucket=256)
    got = scoring.bank_nn_table(padded, k=3, n_valid=200, metric=metric, chunk=64).numpy()
    want = np.asarray(jscore.bank_nn_table(jnp.asarray(padded.numpy()), k=3,
                                           n_valid=200, metric=metric, chunk=64))
    np.testing.assert_array_equal(got[:200], want[:200])
    if metric == "l2":
        assert got[20, 0] == 20 and got[20, 1] == 150 and got[150, :2].tolist() == [20, 150]


def test_patchcore_finish_matches_and_is_overflow_free(rng):
    """Batched eq. 7 + upsample + blur vs the JAX per-sample tail; the
    max-subtracted form stays finite where exp(s*/sqrt(D)) overflows f32."""
    d = 16
    bank = rng.normal(size=(256, d)).astype(np.float32)
    table = scoring.bank_nn_table(_t(bank), k=3)
    patch = rng.normal(size=(2, 64, d)).astype(np.float32)
    patch[1] *= 3000.0               # s*/sqrt(D) ~ 3e4: naive exp overflows
    v, i = scoring.bank_min_dist(_t(patch.reshape(-1, d)), _t(bank))
    s, smap = scoring.patchcore_finish(_t(patch), _t(bank), v.reshape(2, 64),
                                       i.reshape(2, 64), (8, 8), out_size=32,
                                       nn_table=table)
    assert torch.isfinite(s).all() and torch.isfinite(smap).all()
    for b in range(2):
        js, jm = jscore.patchcore_finish(
            jnp.asarray(patch[b]), jnp.asarray(bank), jnp.asarray(v.reshape(2, 64)[b].numpy()),
            jnp.asarray(i.reshape(2, 64)[b].numpy().astype(np.int32)), (8, 8),
            out_size=32, nn_table=jnp.asarray(table.numpy().astype(np.int32)))
        # at 3000x scale the eq. 7 exponents are ~2.5e3, where the f32
        # rounding of the neighbour norms (~1e-7 relative) moves w by ~1e-4
        np.testing.assert_allclose(float(s[b]), float(js), rtol=1e-5 if b == 0 else 1e-3)
        np.testing.assert_allclose(smap[b].numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jm).max()))
    # without the table the neighbourhood is derived from the bank: same s
    s2, _ = scoring.patchcore_finish(_t(patch), _t(bank), v.reshape(2, 64),
                                     i.reshape(2, 64), (8, 8), out_size=32)
    torch.testing.assert_close(s2, s)


def test_patchcore_score_routes_l2_through_the_bf16_selection(rng):
    """l2 on a CPU tensor takes the bank-min kernel's plain version: the
    bfloat16 product chooses the row, the value is that row's exact f32
    distance.  Against the exact path: the same row almost everywhere, the
    same value wherever the row is the same, and elsewhere a near-tie whose
    true distance lies within the bf16 product's envelope (1e-2 relative)
    and never below the true minimum."""
    from cmdiad_tpu_torch.ops.bank_min import bank_min_bf16
    bank = scoring.pad_bank(_t(rng.normal(size=(300, 64)).astype(np.float32)), 256)
    patch = _t(rng.normal(size=(2, 16, 64)).astype(np.float32))
    v, i = bank_min_bf16(patch.reshape(-1, 64), bank)
    ve, ie = scoring.bank_min_dist(patch.reshape(-1, 64), bank, n_valid=300)
    same = i == ie
    assert float(same.float().mean()) >= 0.9
    torch.testing.assert_close(v[same], ve[same], rtol=1e-6, atol=1e-6)
    assert bool((v >= ve - 1e-5).all()) and bool((v <= ve * 1.01).all())
    s, m = scoring.patchcore_score(patch, bank, (4, 4), out_size=16, n_valid=300)
    s_k, m_k = scoring.patchcore_finish(patch, bank, v.reshape(2, 16),
                                        i.reshape(2, 16), (4, 4), out_size=16)
    torch.testing.assert_close(s, s_k)
    torch.testing.assert_close(m, m_k)


# ------------------------------------------------------------ coreset ---

def test_jl_dim_and_projection_matrix():
    for n, eps in ((1000, 0.9), (50176, 0.9), (12544, 0.5)):
        assert coreset.johnson_lindenstrauss_min_dim(n, eps) == \
            jcore.johnson_lindenstrauss_min_dim(n, eps)
    m = coreset.srp_matrix(768, 267, seed=3).numpy()
    density = 1 / np.sqrt(768)
    scale = np.sqrt(1 / density) / np.sqrt(267)
    assert m.shape == (768, 267)
    assert set(np.unique(np.round(m / scale).astype(int))) <= {-1, 0, 1}
    assert abs((m != 0).mean() - density) < 0.01
    assert abs((m > 0).mean() - (m < 0).mean()) < 0.01
    np.testing.assert_array_equal(m, coreset.srp_matrix(768, 267, seed=3).numpy())
    with pytest.raises(ValueError):
        coreset.sparse_random_projection(torch.zeros(1000, 16))


def test_projection_with_the_jax_matrix_matches(rng):
    """The port draws the JAX package's matrix: the projections agree to
    float32 summation order."""
    x = rng.normal(size=(500, 96)).astype(np.float32)
    k = 40
    want = np.asarray(jcore.sparse_random_projection(jnp.asarray(x), seed=0, n_components=k))
    got = coreset.sparse_random_projection(_t(x), seed=0, n_components=k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3, 42])
def test_srp_matrix_is_the_jax_matrix(seed):
    """At the features' width and a 200704-row bank's JL dimension (301):
    the matrix built from ``jax.random.uniform`` as the JAX package builds
    it, and the JAX package's own projection of the identity, bit for bit."""
    import jax
    d, k = 768, jcore.johnson_lindenstrauss_min_dim(200704, 0.9)
    got = coreset.srp_matrix(d, k, seed).numpy()
    u = jax.random.uniform(jax.random.PRNGKey(seed), (d, k))
    density = 1.0 / np.sqrt(d)
    scale = np.sqrt(1.0 / density) / np.sqrt(k)
    want = np.asarray(jnp.where(u < density / 2.0, -scale,
                                jnp.where(u < density, scale, 0.0)).astype(jnp.float32))
    assert np.array_equal(got, want)
    eye = jnp.eye(d, dtype=jnp.float32)
    assert np.array_equal(got, np.asarray(jcore._srp_project(eye, jnp.uint32(seed), k)))


@pytest.mark.parametrize("dtype", ["FP32", "FP16"])
@pytest.mark.parametrize("seed", [0, 42])
def test_coreset_select_picks_the_jax_rows_at_width_768(dtype, seed):
    """A 3000 x 768 bank projects (JL dimension 197): the port's coreset
    picks the JAX package's 300 rows in order.  The projected banks agree
    only to float32 summation order (the two matmuls sum in other orders),
    so on another bank a near-tie can still order two picks otherwise."""
    bank = np.random.default_rng(0).normal(size=(3000, 768)).astype(np.float32)
    got = coreset.coreset_select(_t(bank), 0.1, seed=seed, compute_dtype=dtype).numpy()
    want = np.asarray(jcore.coreset_select(jnp.asarray(bank), 0.1, seed=seed,
                                           compute_dtype=dtype, bucket_rows=1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["FP32", "FP16"])
def test_greedy_kcenter_matches(rng, dtype):
    """Same z, same picks: FP32 exactly; FP16 (bfloat16 distances, f32 sums
    rounded once) exactly on this data too."""
    z = rng.normal(size=(400, 24)).astype(np.float32)
    got = coreset.greedy_kcenter(_t(z), 60, compute_dtype=dtype).numpy()
    want = np.asarray(jcore.greedy_kcenter(jnp.asarray(z), 60, compute_dtype=dtype))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and len(set(got.tolist())) == 60


@pytest.mark.parametrize("n, d", [(1280, 48), (15680, 64)])
def test_greedy_kcenter_bf16_picks_the_jax_rows_at_bank_size(n, d):
    """FP16 over a tenth of a bank's rows: the bfloat16 distances round as
    the JAX package's compiled loop rounds them (squares summed in float32,
    the sum rounded once), so every pick agrees; rounding each square to
    bfloat16 first put another row at 18 and 1216 of these positions."""
    z = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    got = coreset.greedy_kcenter(_t(z), n // 10, compute_dtype="FP16").numpy()
    want = np.asarray(jcore.greedy_kcenter(jnp.asarray(z), n // 10, compute_dtype="FP16"))
    np.testing.assert_array_equal(got, want)


def test_coreset_select_falls_back_to_the_raw_bank(rng):
    bank = rng.normal(size=(300, 16)).astype(np.float32)   # JL dim > 16
    got = coreset.coreset_select(_t(bank), 0.2, compute_dtype="FP32").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcore.greedy_kcenter(jnp.asarray(bank), 60, compute_dtype="FP32")))
