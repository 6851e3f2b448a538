"""The port's kernel modules against the JAX package's kernels.

Each plain PyTorch version (what a kernel wrapper runs for CPU tensors) is
held to the JAX Pallas kernel it replaces, run the way the JAX package runs
it off-TPU (interpret mode), and to the JAX package's jnp path.  The CUDA
kernels are held to these plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu.ops.fps import _fps_batched_pallas, _fps_single_jnp
from cmdiad_tpu.ops.interpolate import three_nn_interpolate as jax_interp
from cmdiad_tpu.ops.pallas_interp import three_nn_interpolate_pallas
from cmdiad_tpu.ops.pallas_scoring import bank_min_dist_pallas
from cmdiad_tpu_torch.ops import bank_min as bm
from cmdiad_tpu_torch.ops import fps
from cmdiad_tpu_torch.ops import interpolate as ip

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _point_sets(rng, b=3, p=256):
    """Random sets with invalid (all-zero) rows, one all-invalid set, and
    one integer lattice whose distances tie exactly."""
    pts = rng.normal(size=(b, p, 3)).astype(np.float32)
    pts[rng.random((b, p)) < 0.3] = 0.0
    pts[1] = 0.0                                             # all invalid
    g = np.arange(1, 6, dtype=np.float32)
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts[2, :] = 0.0
    pts[2, 5:5 + len(lattice)] = lattice                     # exact ties
    return pts


# ---------------------------------------------------------------- FPS ---

def test_fps_plain_matches_pallas_and_jnp(rng):
    """Indices equal exactly, ties and the all-invalid set included: both
    sides sum ((dx² + dy²) + dz²) and take the first maximum."""
    pts = _point_sets(rng)
    mask = np.all(pts != 0, axis=-1)
    g = 48
    want_k = np.asarray(_fps_batched_pallas(jnp.asarray(pts), jnp.asarray(mask), g))
    want_j = np.asarray(jax.vmap(lambda p, m: _fps_single_jnp(p, m, g))(
        jnp.asarray(pts), jnp.asarray(mask)))
    got = fps._fps_plain(_t(pts), _t(mask), g).numpy()
    np.testing.assert_array_equal(got, want_k)
    np.testing.assert_array_equal(got, want_j)
    assert np.all(got[1] == 0)                        # all-invalid -> index 0
    assert mask[0][got[0][: mask[0].sum()]].all()     # never an invalid point


@pytest.mark.parametrize("case", ["all_invalid", "more_centers_than_valid",
                                  "ragged_span"])
def test_fps_plain_matches_pallas_and_jnp_edge_cases(rng, case):
    """The cases the cluster kernel treats apart, equal on all three sides:
    an all-invalid set (index 0 throughout), more centers than valid points
    (indices repeat), and a P that is not a multiple of the kernel's CTA
    span (512 threads x 2 points), nor of the TPU kernel's 128 lanes."""
    p, g = {"all_invalid": (256, 24), "more_centers_than_valid": (256, 40),
            "ragged_span": (1300, 32)}[case]
    pts = rng.normal(size=(2, p, 3)).astype(np.float32)
    if case == "all_invalid":
        pts[0] = 0.0
        pts[1, :, 0] = 0.0                      # nonzero rows, none valid
    elif case == "more_centers_than_valid":
        pts[:, 12:] = 0.0                       # 12 valid of 256
        pts[1, 3] = pts[1, 7]                   # a duplicate: a tie at 0
    else:
        pts[rng.random((2, p)) < 0.3] = 0.0
        pts[1, 1100:1110] = pts[1, 1200:1210]   # ties past the first span
    mask = np.all(pts != 0, axis=-1)
    want_k = np.asarray(_fps_batched_pallas(jnp.asarray(pts), jnp.asarray(mask), g))
    want_j = np.asarray(jax.vmap(lambda q, m: _fps_single_jnp(q, m, g))(
        jnp.asarray(pts), jnp.asarray(mask)))
    got = fps._fps_plain(_t(pts), _t(mask), g).numpy()
    np.testing.assert_array_equal(got, want_k)
    np.testing.assert_array_equal(got, want_j)
    if case == "all_invalid":
        assert np.all(got == 0)
    elif case == "more_centers_than_valid":
        assert set(got[0].tolist()) == set(range(12))   # every valid point
        assert np.all(mask[np.arange(2)[:, None], got])


def _cluster_argmax(values, c, threads, k):
    """The kernel's argmax (csrc/fps.cu) over rows of running distances:
    each row padded to c CTAs x ``threads`` x ``k`` slots, thread t of CTA r
    holding indices r*threads*k + t + threads*j (j = 0..k-1), scanned in
    that order with a strict '>'; the thread's key (``ABSENT_KEY`` where it
    holds no point) then maximised over the threads of a CTA and over the
    CTAs."""
    b, p = values.shape
    span = threads * k
    out = []
    for row in values:
        cta_keys = []
        for r in range(c):
            best = torch.full((threads,), fps.ABSENT_KEY)
            bv = torch.full((threads,), -np.inf)
            for j in range(k):
                idx = r * span + torch.arange(threads) + threads * j
                inside = idx < p
                v = torch.where(inside, row[idx.clamp(max=p - 1)],
                                torch.tensor(-np.inf))
                take = inside & (v > bv)
                bv = torch.where(take, v, bv)
                best = torch.where(take, fps.pack_argmax_keys(v, idx), best)
            cta_keys.append(best.max())
        out.append(fps.unpack_argmax_index(torch.stack(cta_keys).max()))
    return torch.stack(out)


@pytest.mark.parametrize("c,threads,k", [(8, 4, 2), (16, 4, 2), (8, 8, 4)])
def test_argmax_keys_merge_over_cluster_ranks_matches_torch_argmax(
        rng, c, threads, k):
    """The key merge over threads and CTA ranks gives torch.argmax's first
    occurrence: ties planted inside a thread, across threads and across
    ranks, distance 0 ties, -1 (invalid) entries, an all-invalid row (index
    0) and padding slots past P, which never win, not even against -1."""
    span = threads * k
    p = c * span - 5                                  # the last slots pad
    v = rng.integers(0, 50, (6, p)).astype(np.float32)
    v[rng.random((6, p)) < 0.3] = -1.0
    v[1] = -1.0                                       # all invalid
    v[2] = 0.0                                        # every point a tie
    v[3, [3, 3 + threads, 3 + span, p - 1]] = 99.0    # thread, rank ties
    v[4, :] = -1.0
    v[4, [p - 1, 2 * span + 1]] = 7.0                 # tie in the last rank
    v[5, :span] = -1.0                                # rank 0 holds no valid
    t = _t(v)
    np.testing.assert_array_equal(
        _cluster_argmax(t, c, threads, k).numpy(), torch.argmax(t, 1).numpy())


@pytest.mark.parametrize("kind", ["negative", "positive", "mixed"])
def test_argmax_keys_order_is_value_then_lowest_index(rng, kind):
    """Sorting the keys sorts by value, then by the lower index first (-0.0
    equal to +0.0); every key lies above ``ABSENT_KEY``; the index comes
    back."""
    v = _key_values(rng, kind)
    idx = rng.permutation(v.size)
    keys = fps.pack_argmax_keys(_t(v), _t(idx))
    np.testing.assert_array_equal(torch.argsort(keys).numpy(),
                                  np.lexsort((-idx, v)))
    assert bool((keys > fps.ABSENT_KEY).all())
    np.testing.assert_array_equal(fps.unpack_argmax_index(keys).numpy(), idx)


def test_fps_entry_point_gathers_centers(rng):
    pts = _point_sets(rng)
    centers, idx = fps.farthest_point_sample(_t(pts), _t(np.all(pts != 0, -1)), 16)
    np.testing.assert_array_equal(
        centers.numpy(), np.take_along_axis(pts, idx.numpy()[..., None], 1))


# ------------------------------------------------------------- interp ---

def _interp_inputs(rng, b=2, p=300, g=128, d=128):
    pts = rng.normal(size=(b, p, 3)).astype(np.float32)
    pts[rng.random((b, p)) < 0.2] = 0.0
    mask = np.all(pts != 0, axis=-1)
    # centers are valid input points (coincident pairs hit the clamp at 0)
    cidx = np.stack([rng.choice(np.flatnonzero(mask[i]), g, replace=False)
                     for i in range(b)])
    centers = np.take_along_axis(pts, cidx[..., None], 1)
    feats = rng.normal(size=(b, g, d)).astype(np.float32)
    return pts, mask, centers, feats


def test_interp_plain_matches_pallas_kernel(rng):
    """Same 3 centres and weights; the sums differ in order (the TPU kernel
    adds in centre-index order through a one-hot product), so 1e-5 on unit
    features.  At a coincident pair the clamp decides d = 0 vs +1e-8, which
    moves the other two weights by ~1e-6 of the total."""
    pts, mask, centers, feats = _interp_inputs(rng)
    want = np.asarray(three_nn_interpolate_pallas(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers),
        jnp.asarray(feats)))
    got = ip._three_nn_plain(_t(pts), _t(mask), _t(centers), _t(feats), False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.all(got.numpy()[~mask] == 0)
    # IDW clamp: every output is a convex combination of centre features
    lo = feats.min(axis=1)[:, None, :] - 1e-5
    hi = feats.max(axis=1)[:, None, :] + 1e-5
    assert np.all((got.numpy() >= lo) & (got.numpy() <= hi))


def test_interp_plain_bf16_matches_pallas_kernel(rng):
    """bf16 weights and features, f32 sums, bf16 output: one bf16 ulp."""
    pts, mask, centers, feats = _interp_inputs(rng)
    want = np.asarray(three_nn_interpolate_pallas(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers),
        jnp.asarray(feats), compute_dtype="bfloat16",
        out_dtype="bfloat16")).astype(np.float32)
    got = ip.three_nn_interpolate(_t(pts), _t(mask), _t(centers), _t(feats),
                                  compute_dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("g,d", [(5, 7), (9, 3)])
def test_interp_plain_matches_jnp_path(rng, g, d):
    """Tiny shapes through the JAX package's jnp path (the one-hot form)."""
    pts, mask, centers, feats = _interp_inputs(rng, p=40, g=g, d=d)
    want = np.asarray(jax_interp(jnp.asarray(pts), jnp.asarray(mask),
                                 jnp.asarray(centers), jnp.asarray(feats),
                                 use_pallas=False))
    got = ip.three_nn_interpolate(_t(pts), _t(mask), _t(centers), _t(feats))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_interp_ties_go_to_the_first_center():
    """Two centres at the same distance: the lower index takes the larger
    share only by order, and both orders give equal weights — but the
    selected SET must be the first three by (distance, index)."""
    pts = np.array([[[1.0, 1.0, 1.0]]], np.float32)
    centers = np.array([[[1, 1, 2], [1, 1, 0.5], [1, 2, 1], [1, 0.5, 1.0],
                         [2, 1, 1]]], np.float32)   # d = 1, .25, 1, .25, 1
    feats = np.eye(5, dtype=np.float32)[None]
    got = ip.three_nn_interpolate(_t(pts), _t(np.ones((1, 1), bool)),
                                  _t(centers), _t(feats)).numpy()[0, 0]
    want = np.asarray(jax_interp(jnp.asarray(pts), jnp.ones((1, 1), bool),
                                 jnp.asarray(centers), jnp.asarray(feats),
                                 use_pallas=False))[0, 0]
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] > 0 and got[2] == 0 and got[4] == 0   # centre 0 of the d=1 tie


# ----------------------------------------------------------- bank min ---

def _bank_inputs(rng, nq=100, nb=2048, d=64):
    q = rng.normal(size=(nq, d)).astype(np.float32)
    bank = rng.normal(size=(nb, d)).astype(np.float32)
    bank[1500] = bank[10]           # duplicate rows: the first one must win
    q[7] = bank[10]
    return q, bank


@pytest.mark.parametrize("refine", [True, False])
def test_bank_min_plain_matches_pallas_kernel(rng, refine):
    """bf16 products summed in f32 on both sides: the same rows (including
    the first of two duplicates); refined values are the exact f32 distance
    of the chosen row; raw values agree to f32 summation order."""
    q, bank = _bank_inputs(rng)
    want_v, want_i = bank_min_dist_pallas(jnp.asarray(q), jnp.asarray(bank),
                                          tile=1024, refine=refine)
    got_v, got_i = bm.bank_min_bf16(_t(q), _t(bank), refine=refine)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i[7] == 10
    if refine:
        exact = np.sqrt(((q.astype(np.float64) - bank[got_i.numpy()]) ** 2).sum(1))
        np.testing.assert_allclose(got_v.numpy(), exact, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5,
                                   atol=2e-3)


def test_refine_removes_the_raw_product_error(rng):
    """Refined vs raw value for queries next to a bank row: the raw bf16
    cross term errs in proportion to the row norms, not the distance (the
    trap the JAX package measured); the refine gives the exact f32 value."""
    q, bank = _bank_inputs(rng)
    q[:20] = bank[100:120] + 1e-3 * rng.normal(size=(20, q.shape[1]))
    raw, idx = bm.bank_min_bf16(_t(q), _t(bank), refine=False)
    ref, _ = bm.bank_min_bf16(_t(q), _t(bank), refine=True)
    exact = np.sqrt(((q.astype(np.float64) - bank[idx.numpy()]) ** 2).sum(1))
    assert np.max(np.abs(raw.numpy() - exact)[:20]) > 1e-2
    np.testing.assert_allclose(ref.numpy(), exact, rtol=1e-6, atol=1e-6)


# The bf16 kernel publishes each query's (value, row) as one 64-bit key
# with atomicMin from CTAs that each saw a 2-D tile of the product; the
# wrapper unpacks the keys.  These tests hold the packing to the
# lexicographic (value, lowest row) order the strict '<' scan gives.

def _key_values(rng, kind):
    """float32 values of one sign pattern, with ±0.0, extremes, subnormals
    and planted ties (every value repeated at other rows)."""
    v = rng.normal(size=300) * 10.0 ** rng.integers(-30, 30, 300)
    if kind == "negative":
        v = -np.abs(v)
    elif kind == "positive":
        v = np.abs(v)
    v = np.concatenate([v, [0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38]])
    v = v.astype(np.float32)
    return np.concatenate([v, v[::-1], v[:40]])


@pytest.mark.parametrize("kind", ["negative", "positive", "mixed"])
def test_min_keys_round_trip(rng, kind):
    """unpack(pack(v, row)) gives v back bit for bit (-0.0 as +0.0) and the
    row, rows up to 2^31 - 1."""
    v = _key_values(rng, kind)
    rows = rng.integers(0, 2 ** 31 - 1, v.size)
    rows[:3] = [0, 1, 2 ** 31 - 1]
    got_v, got_i = bm.unpack_min_keys(bm.pack_min_keys(_t(v), _t(rows)))
    assert got_i.dtype == torch.int64 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), rows)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  (v + np.float32(0.0)).view(np.int32))


@pytest.mark.parametrize("kind", ["negative", "positive", "mixed"])
def test_min_keys_order_is_value_then_lowest_row(rng, kind):
    """Sorting the keys sorts by (value, row), -0.0 equal to +0.0; so the
    minimum key is the first row of the minimum value."""
    v = _key_values(rng, kind)
    rows = rng.permutation(v.size)
    keys = bm.pack_min_keys(_t(v), _t(rows))
    np.testing.assert_array_equal(torch.argsort(keys).numpy(),
                                  np.lexsort((rows, v)))
    lo = v == v.min()
    assert int(bm.unpack_min_keys(keys.min())[1]) == rows[lo].min()


def _split_scan_inputs(rng, mode, splits, nb=512, d=64):
    """Operands of either mode whose products are exact, so ties are exact:
    integer-valued bfloat16 rows, or int8 rows with power-of-two scales.
    Equal rows on both sides of every split, queries equal to the row before
    a split (zero distance: negative raw values |b|^2 - 2 b.b) and one row
    off it.  Returns the plain version over a row range and the arguments."""
    q = rng.integers(-3, 4, (90, d)).astype(np.float32)
    bank = rng.integers(-3, 4, (nb, d)).astype(np.float32)
    for j, s in enumerate(splits):
        bank[s:s + 2] = bank[s - 2:s]             # equal rows either side
        q[2 * j] = bank[s - 1]                    # exact ties at distance 0
        q[2 * j + 1] = bank[s - 2] + 1.0          # ties away from zero
    if mode == "bf16":
        qb, bb = _t(q).to(torch.bfloat16), _t(bank).to(torch.bfloat16)
        bnorm = torch.sum(_t(bank) ** 2, 1)

        def plain(lo, hi, chunk=8192):
            return bm._bank_min_plain(qb, bb[lo:hi], bnorm[lo:hi], chunk=chunk)
    else:
        q8, b8 = _t(q).to(torch.int8), _t(bank).to(torch.int8)
        qs = torch.full((q.shape[0],), 0.5)
        bs = torch.full((nb,), 0.5)
        bnorm = torch.sum((_t(bank) * 0.5) ** 2, 1)

        def plain(lo, hi, chunk=8192):
            return bm._bank_min_int8_plain(q8, qs, b8[lo:hi], bs[lo:hi],
                                           bnorm[lo:hi], chunk=chunk)
    return plain


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [(64,), (64, 192), (128, 320, 448),
                                    (64, 128, 192, 256, 384)])
def test_min_key_merge_over_bank_splits_matches_the_strict_scan(rng, splits,
                                                                mode):
    """Each split of the bank rows (a bank tile of either kernel) gives its
    own (min, first argmin); the minimum of the packed keys over the
    splits equals the plain version's chunked strict-'<' scan, ties
    planted across every split boundary and negative values included."""
    nb = 512
    plain = _split_scan_inputs(rng, mode, splits, nb)
    want_v, want_i = plain(0, nb, chunk=96)
    keys = torch.full((want_v.shape[0],), torch.iinfo(torch.int64).max)
    for lo, hi in zip((0,) + splits, splits + (nb,)):
        v, i = plain(lo, hi)
        keys = torch.minimum(keys, bm.pack_min_keys(v, i + lo))
    got_v, got_i = bm.unpack_min_keys(keys)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())
    for j, s in enumerate(splits):
        assert int(got_i[2 * j]) <= s - 1          # never the later copy
    if mode == "int8":
        assert float(got_v.min()) < 0              # negative raw values


# ------------------------------------------------------ int8 bank min ---

def test_quantize_rows_matches_jax(rng):
    """Per-row int8 quantisation: the same int8 rows and scales as the JAX
    package's ``_quantize_rows``, bank padding rows and all-zero rows
    included (round half to even on both sides)."""
    from cmdiad_tpu.ops.pallas_scoring import _quantize_rows
    from cmdiad_tpu_torch.ops.scoring import PAD_VALUE
    x = rng.normal(size=(40, 64)).astype(np.float32)
    x[3] = PAD_VALUE                                  # a bank padding row
    x[5] = 0.0                                        # a zero query row
    x[7, :4] = [127.0, 0.5, 1.5, -2.5]                # exact halves
    x[7, 4:] = 0.0
    want_q, want_s = _quantize_rows(jnp.asarray(x))
    got_q, got_s = bm.quantize_rows(_t(x))
    assert got_q.dtype == torch.int8 and got_s.shape == (40,)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s)[:, 0])
    assert (got_q[5] == 0).all() and (got_q[3] == 127).all()
    np.testing.assert_array_equal(got_q[7, :4].numpy(), [127, 0, 2, -2])


@pytest.mark.parametrize("refine", [True, False])
def test_bank_min_int8_plain_matches_pallas_kernel(rng, refine):
    """s8.s8 products exact on both sides and the same dequantise order:
    the same rows, the first of two duplicates included; values to 1e-5."""
    q, bank = _bank_inputs(rng, nq=300, nb=2048, d=64)
    bank[2040:] = 1e6                               # padding rows never win
    want_v, want_i = bank_min_dist_pallas(jnp.asarray(q), jnp.asarray(bank),
                                          tile=256, compute_dtype="int8",
                                          refine=refine)
    got_v, got_i = bm.bank_min_int8(_t(q), _t(bank), refine=refine)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i[7] == 10
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5,
                               atol=1e-5)


def test_bank_min_int8_raw_values_are_the_quantised_distance(rng):
    """The plain version's raw value is |b|^2 - 2 float(q8.b8)(bs qs) of the
    row it returns, and no row has a smaller one (float64 recomputation)."""
    q, bank = _bank_inputs(rng, nq=50, nb=2048, d=32)
    q8, qs = bm.quantize_rows(_t(q))
    b8, bs = bm.quantize_rows(_t(bank))
    bnorm = torch.sum(_t(bank) ** 2, 1)
    v, i = bm._bank_min_int8_plain(q8, qs, b8, bs, bnorm)
    prod = q8.double() @ b8.double().T
    d2 = (bnorm.double()[None] - 2 * prod * (bs.double()[None] * qs.double()[:, None]))
    np.testing.assert_allclose(v.double().numpy(), d2.min(1).values.numpy(),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(i.numpy(), d2.argmin(1).numpy())


# ---------------------------------------------------- fused attention ---

def _flash_pallas(q, k, v, scale):
    """The JAX package's kernel as its own wrapper feeds it: q pre-scaled
    in its dtype, heads split, sequence padded to 128 rows and (bfloat16)
    the head dim padded as ``_head_pad`` does; run in interpret mode."""
    from cmdiad_tpu.ops.flash_attn import BLOCK_Q, _flash_call, _head_pad
    b, n, h, d = q.shape
    n_pad = -(-n // BLOCK_Q) * BLOCK_Q
    d_pad = _head_pad(d, q.dtype)

    def th(x):
        x = x.transpose(0, 2, 1, 3).reshape(b * h, n, d)
        return jnp.pad(x, ((0, 0), (0, n_pad - n), (0, d_pad - d)))

    qt = th(q * jnp.asarray(scale, q.dtype)).transpose(0, 2, 1)
    o = _flash_call(qt, th(k), th(v), n)
    return np.asarray(o[:, :n, :d].reshape(b, h, n, d).transpose(0, 2, 1, 3)
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 135])
def test_fused_attention_plain_matches_pallas_kernel(rng, n, dtype):
    """float32: summation order only (2e-5).  bfloat16: the same scores in
    float32 and the same rounding points (p and the output), so the two
    differ where a float32 sum rounds to the other neighbour in bfloat16:
    at most one bfloat16 ulp of the output (2^-7 relative) plus a p ulp."""
    from cmdiad_tpu_torch.ops.flash_attn import fused_attention
    b, h, d = 2, 2, 64
    x = [rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    scale = d ** -0.5
    want = _flash_pallas(*[jnp.asarray(a, jdt) for a in x], scale)
    got = fused_attention(*[_t(a).to(tdt) for a in x], scale, use_flash=True)
    assert got.dtype == tdt and got.shape == (b, n, h, d)
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-3)
        assert np.mean(got != want) < 0.05


def _flash_bf16_kernel_arithmetic(q, k, v, scale):
    """The bfloat16 CUDA kernel's arithmetic (csrc/flash_attn.cu), on the
    CPU: q scaled and rounded to bfloat16; float32 scores; pass 1 folds
    64-key tiles into a running max m and sum l per row, each of a row's
    four threads over its own columns (key % 8 in {2 t, 2 t + 1}), with
    exp(x) as 2^(x log2 e) on log2 e-prescaled scores, the four combined
    after the last tile; pass 2 forms p = 2^(s log2 e - m log2 e) * (1/l)
    with one reciprocal per row, rounds p to bfloat16, and sums p.v in
    float32.  FMAs are taken in float64 and rounded once; ex2.approx as
    the exact power of two rounded to float32."""
    f32 = torch.float32

    def fma(a, b, c):
        return (a.double() * b + c.double()).to(f32)

    def ex2(x):
        return torch.exp2(x.double()).to(f32)

    log2e = float(np.float32(1.4426950408889634))
    n = q.shape[1]
    qs = (q.float() * float(torch.tensor(scale, dtype=torch.bfloat16)))
    s = torch.einsum("bnhd,bmhd->bhnm", qs.to(torch.bfloat16).float(), k.float())
    lane = (torch.arange(n) % 8) // 2
    m = torch.full(s.shape[:3] + (4,), -np.inf, dtype=f32)
    l = torch.zeros(s.shape[:3] + (4,), dtype=f32)
    for k0 in range(0, n, 64):
        tile = s[..., k0:k0 + 64]
        for t in range(4):
            st = tile[..., lane[k0:k0 + 64] == t]
            if st.shape[-1] == 0:
                continue
            mn = torch.maximum(m[..., t], st.amax(-1))
            mnl = torch.where(mn == -np.inf, 0.0, mn * log2e)
            total = ex2(fma(st, log2e, -mnl[..., None])).sum(-1)
            l[..., t] = fma(l[..., t], ex2(fma(m[..., t], log2e, -mnl)), total)
            m[..., t] = mn
    mx = m.amax(-1)
    lt = (l * ex2((m - mx[..., None]) * log2e)).sum(-1)
    p = ex2(fma(s, log2e, -(mx * log2e)[..., None])) * (1.0 / lt)[..., None]
    o = torch.einsum("bhnm,bmhd->bnhd", p.to(torch.bfloat16).float(), v.float())
    return o.to(torch.bfloat16)


@pytest.mark.parametrize("n", [64, 135, 257])
def test_flash_kernel_arithmetic_matches_plain_and_pallas(rng, n):
    """The CUDA kernel's bfloat16 arithmetic (online tiles, exp2 on
    prescaled scores, one reciprocal per row) moves p by float32 ulps
    before its bfloat16 rounding, so it stays within chip_smoke.py's
    FLASH_TOL of the plain version and of the JAX kernel (interpret mode).
    n covers a ragged last tile of 64 keys and of 128 queries."""
    from chip_smoke import FLASH_TOL
    from cmdiad_tpu_torch.ops.flash_attn import _fused_attention_plain
    b, h, d = 2, 2, 64
    x = [rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3)]
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in x)
    got = _flash_bf16_kernel_arithmetic(tq, tk, tv, d ** -0.5).float().numpy()
    rtol, atol = FLASH_TOL["bfloat16"]
    plain = _fused_attention_plain(tq, tk, tv, d ** -0.5).float().numpy()
    np.testing.assert_allclose(got, plain, rtol=rtol, atol=atol)
    assert np.mean(got != plain) < 0.05
    pallas = _flash_pallas(*[jnp.asarray(a, jnp.bfloat16) for a in x], d ** -0.5)
    np.testing.assert_allclose(got, pallas, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_einsum_attention_matches_jax_fallback(rng, dtype):
    """use_flash=False is the JAX package's einsum fallback, rounding of
    the bfloat16 scores included.  In bfloat16 the two sum the scores in
    another float32 order, so now and then a score rounds to the other
    bfloat16 neighbour: one score ulp (2^-7 relative, |s| < 4 here) moves
    that key's p by as much, which moves the output by up to ~1e-2 at
    |v| < 4.  Elsewhere the outputs differ by their own rounding (one ulp,
    2^-8 relative), so the mean difference stays below that."""
    from cmdiad_tpu.ops.flash_attn import fused_attention as jax_attention
    from cmdiad_tpu_torch.ops.flash_attn import fused_attention
    x = [rng.normal(size=(2, 135, 2, 32)).astype(np.float32) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jax_attention(*[jnp.asarray(a, jdt) for a in x], 32 ** -0.5,
                                    use_flash=False).astype(jnp.float32))
    got = fused_attention(*[_t(a).to(tdt) for a in x], 32 ** -0.5,
                          use_flash=False).to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)
        assert np.mean(np.abs(got - want)) <= 2 ** -8 * np.mean(np.abs(want))


# --------------------------------------------------------- int8 probe ---

@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (192, 256, 320)])
def test_int8_dot_plain_matches_the_probe_kernel(rng, m, k, n):
    """The probe's Pallas kernel (interpret mode) on its small shape and on
    one whose M and N are not multiples of the CUDA kernel's 128 x 256
    tile: int8 exact, bfloat16 to float32 summation order."""
    import functools
    import importlib.util
    from pathlib import Path
    from jax.experimental import pallas as pl
    from cmdiad_tpu_torch.ops.int8_dot import int8_dot
    spec = importlib.util.spec_from_file_location(
        "probe_int8_dot",
        Path(__file__).resolve().parents[1] / "benchmarks" / "probe_int8_dot.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    a = rng.integers(-127, 127, (m, k)).astype(np.int8)
    b = rng.integers(-127, 127, (k, n)).astype(np.int8)
    for jdt, acc, tdt in ((jnp.int8, jnp.int32, torch.int8),
                          (jnp.bfloat16, jnp.float32, torch.bfloat16)):
        want = np.asarray(pl.pallas_call(
            functools.partial(probe._kern, acc_dtype=acc),
            out_shape=jax.ShapeDtypeStruct((m, n), acc), interpret=True)(
                jnp.asarray(a, jdt), jnp.asarray(b, jdt)))
        got = int8_dot(_t(a).to(tdt), _t(b.T.copy()).to(tdt)).numpy()
        if tdt == torch.int8:
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-2)


def test_build_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library name changes with its source, its flags and any
    header in csrc/ (a header edit must not load a stale library), and not
    with another kernel's source."""
    from cmdiad_tpu_torch import kernels
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    src, header, other = (tmp_path / n for n in ("a.cu", "h.cuh", "b.cu"))
    src.write_text('#include "h.cuh"\n')
    header.write_text("// v1\n")
    other.write_text("// b\n")
    base = kernels._digest(src, ["-O3"])
    assert kernels._digest(src, ["-O3"]) == base
    assert kernels._digest(src, ["-O2"]) != base
    other.write_text("// b, edited\n")
    assert kernels._digest(src, ["-O3"]) == base
    header.write_text("// v2\n")
    assert kernels._digest(src, ["-O3"]) != base
