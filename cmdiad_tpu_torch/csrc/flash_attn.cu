// Fused multi-head self-attention, softmax(q.k^T).v per (batch, head).
//
// Replaces the TPU kernel cmdiad_tpu/ops/flash_attn.py:_attn_kernel
// (reached through fused_attention with use_flash=True).  Semantics, as
// there: q arrives pre-scaled in the compute dtype; scores are products of
// compute-dtype operands summed in float32 and stay float32; keys past the
// sequence end get -inf; the softmax runs in float32 with the true row max
// and the normalised p is rounded to the compute dtype before p.v; p.v
// accumulates in float32 and the output is rounded to the compute dtype.
// The TPU's paddings (head dim 64 -> 128 lanes, 785 -> 1024 keys) were
// layout and are not carried over: the ragged last tile is masked in place.
//
// What bounds it on the card: at the backbones' shapes (B 8, 12 heads x
// 785 tokens, or 6 heads x 1024 tokens, head dim 64) the two n x n x 64
// products q.k^T and p.v are 15.1 and 12.9 GFLOP (15.3 and 13.0 us in
// bfloat16 at 989 TFLOP/s), and each score needs one exponential: 59.2 M
// and 50.3 M of them, 15.2 and 12.9 us at the special-function unit's
// ~3.9 T/s.  Rounding p after normalisation (below) takes a second pass
// over the keys: 1.5 x the products and two exponentials per score, a
// floor near 31 and 26 us.  In float32 the FFMA rate decides: about 226
// and 192 us at 67 TFLOP/s.
//
// bfloat16 design: two passes over the keys, so that p is rounded after
// normalisation where the TPU kernel rounds it.  Persistent CTAs, one per
// SM, walk items of (batch.head, 64 kCW queries): kCW consumer warpgroups
// of 64 queries and a producer warpgroup, one thread of which issues TMA.
// Items go head by head, except that each head's ragged last query tile
// (17 queries at 785 tokens) waits until every full tile is out, so the
// light items fill the last round instead of lengthening it.
//   * The head's whole K (at most 1408 keys, 176 KB) is loaded once by TMA
//     into shared memory, one mbarrier per 64-key tile so that pass 1
//     starts on the first tile; both passes read it there, and the next
//     item's tile j loads as soon as pass 2 has let tile j go.  V streams
//     through a 3-stage TMA ring in pass 2.  The tensor maps address the
//     (B, N, 3, H, 64) qkv projection in place through its strides.
//   * Pass 1: S = Q.K^T by wgmma m64n64k16 (q in registers, K in shared
//     memory); the next tile's wgmma runs while this tile's running max
//     and sum are taken.  Pass 2 recomputes S, forms
//     p = exp2(s log2 e - m log2 e) * (1 / l) with 1 / l computed once per
//     row, packs it to bfloat16 straight into the A registers of the p.V
//     wgmma (the S accumulator layout is the A fragment layout), and takes
//     V as the transposed (MN-major) B operand from shared memory.
//   * Special-function work is two exponentials per score (ex2.approx on
//     log2 e-prescaled scores, one FMA each) and no divide per element;
//     each moves p by float32 ulps before the bfloat16 rounding.
//   * Three consumer warpgroups hide the softmax's latencies better than
//     two; two cut the work into finer items.  The launcher takes three
//     unless two need fewer warpgroup-rounds: the ViT shape takes three,
//     the Point-MAE shape two.
// float32 design: plain FFMA (no TF32) and one pass with an online softmax:
// rounding the normalised p to float32 is the identity, so p.v / l differs
// from the two-pass form by float32 rounding only.  One CTA of 256 threads
// per (batch.head, 64 queries); each thread owns a 4 x 4 block of the score
// tile (queries ty + 16a, keys tx + 16b) and a 4 x 4 block of the output,
// so every value read from shared memory feeds four FMAs.  K and V tiles of
// 64 keys are double-buffered with cp.async.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;            // head dim
constexpr int kBKey = 64;         // keys per tile
constexpr unsigned kFull = 0xffffffffu;

// bfloat16 kernel
constexpr int kVStages = 3;       // depth of the V ring
constexpr int kTile = kBKey * kD;  // bf16 elements per 64-key tile
constexpr float kLog2e = 1.4426950408889634f;

// A CTA of kCW consumer warpgroups, 64 queries each, and a producer
// warpgroup whose registers go to the consumers (setmaxnreg).
template <int kCW>
struct Shape {
  static constexpr int kBQ = 64 * kCW;  // queries per item
  static constexpr int kThreads = 128 * (kCW + 1);
  static constexpr int kProducerRegs = kCW == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = kCW == 2 ? 232 : 160;
  // resident K tiles that fit beside Q, the V ring and the barriers
  static constexpr int kMaxKeyTiles =
      (232448 - 1024 - 512 - (kBQ * kD + kVStages * kTile) * 2) / (kTile * 2);
};
// 22 tiles, N <= 1408, for both shapes
constexpr int kMaxKeyTiles = Shape<3>::kMaxKeyTiles;

// float32 kernel
constexpr int kFQ = 64;           // queries per CTA
constexpr int kFThreads = 256;    // 16 x 16
constexpr int kFPad = kD + 4;     // floats per padded shared row

// Keep the compiler from touching registers of an asynchronous wgmma
// before the wait that completes it.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// D (64 x 64, f32) = scale_d * D + A (64 x 16, bfloat16 fragments in
// registers) . B, B bfloat16 in shared memory: K-major (B^T stored, as K
// for q.k^T) or, with kTransB, MN-major (as V for p.V).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTransB));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One warpgroup's 64 x 64 score tile S = Q . K_j^T, q from registers.
// s[4 jn + 2 h + e] is query row g + 8 h of the warp's 16 and key
// 8 jn + 2 t4 + e of the tile.
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const uint32_t (&qf)[4][4],
                                             uint64_t dk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_m64n64k16_rs<0>(s, qf[kk], dk + 2 * kk, kk != 0);
  wgmma_commit();
}

// Keys past the sequence end get -inf (the last tile only).
__device__ __forceinline__ void mask_tail(float (&s)[32], int k0, int N,
                                          int t4) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (k0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= N) s[i] = -INFINITY;
}

// Pass 1: fold one tile into the thread's running max m and sum l of its
// two rows, over its own 16 columns of each (the row's four threads
// combine theirs after the last tile, so the loop needs no shuffles).
__device__ __forceinline__ void row_stats(const float (&s)[32], float (&m)[2],
                                          float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx[8];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      mx[jn] = fmaxf(s[4 * jn + 2 * h], s[4 * jn + 2 * h + 1]);
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) mx[i] = fmaxf(mx[i], mx[i + w]);
    const float mn = fmaxf(m[h], mx[0]);
    // all of this thread's keys so far past the end: nothing to add
    const float mnl = mn == -INFINITY ? 0.0f : mn * kLog2e;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sum[(2 * jn + e) & 3] += ex2(fmaf(s[4 * jn + 2 * h + e], kLog2e, -mnl));
    l[h] = fmaf(l[h], ex2(fmaf(m[h], kLog2e, -mnl)),
                (sum[0] + sum[1]) + (sum[2] + sum[3]));
    m[h] = mn;
  }
}

// Pass 2: p = exp(s - m) / l in place, as exp2(s log2 e - m log2 e) * r
// with r = 1 / l (zero where s is -inf).
__device__ __forceinline__ void probs(float (&s)[32], const float (&ml)[2],
                                      const float (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], kLog2e, -ml[h])) * r[h];
  }
}

// p rounded to bfloat16 as the A fragments of the p.V product: p[kk]
// covers keys 16 kk .. 16 kk + 15 of the tile (rows g, g + 8, g, g + 8).
__device__ __forceinline__ void pack_probs(const float (&s)[32],
                                           uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jn = 2 * kk + (i >> 1), h = i & 1;
      p[kk][i] = pack_bf16(s[4 * jn + 2 * h], s[4 * jn + 2 * h + 1]);
    }
}

template <int kCW>
__global__ void __launch_bounds__(Shape<kCW>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ out, int N, int H, int BH,
                  float scale) {
  using S = Shape<kCW>;
  constexpr int kBQ = S::kBQ;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Vs = Qs + kBQ * kD;
  __nv_bfloat16* Ks = Vs + kVStages * kTile;
  const int nkt = (N + kBKey - 1) / kBKey;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(Ks + nkt * kTile);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qempty + 1;
  uint64_t* kempty = kfull + S::kMaxKeyTiles;
  uint64_t* vfull = kempty + S::kMaxKeyTiles;
  uint64_t* vempty = vfull + kVStages;
  const int nqt = (N + kBQ - 1) / kBQ;
  const int items = BH * nqt;  // (batch.head, kBQ queries)
  // head-major, but a ragged last query tile of every head goes after all
  // full tiles, so that these light items fill the last round
  const int nfull = N % kBQ ? nqt - 1 : nqt;
  auto item = [&](int it, int& bh, int& q0) {
    if (it < BH * nfull) {
      bh = it / nfull;
      q0 = (it % nfull) * kBQ;
    } else {
      bh = it - BH * nfull;
      q0 = nfull * kBQ;
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 128 * kCW);  // every consumer thread, once its q is read
    for (int j = 0; j < nkt; ++j) {
      mbar_init(&kfull[j], 1);
      mbar_init(&kempty[j], kCW);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], kCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: the next item's q and K tiles load as soon as the current
    // item has let go of them, V streams through its ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(S::kProducerRegs));
    if (threadIdx.x == 0) {
      int vc = 0;
      for (int it = blockIdx.x, li = 0; it < items; it += gridDim.x, ++li) {
        int bh, q0;
        item(it, bh, q0);
        const int b = bh / H, head = bh % H;
        mbar_wait(qempty, (li & 1) ^ 1);
        mbar_expect_tx(qfull, kBQ * kD * 2);
        tma_load_4d(Qs, &tq, qfull, 0, head, q0, b);
        for (int j = 0; j < nkt; ++j) {
          mbar_wait(&kempty[j], (li & 1) ^ 1);
          mbar_expect_tx(&kfull[j], kTile * 2);
          tma_load_4d(Ks + j * kTile, &tk, &kfull[j], 0, head, j * kBKey, b);
        }
        for (int j = 0; j < nkt; ++j, ++vc) {
          const int s = vc % kVStages;
          mbar_wait(&vempty[s], ((vc / kVStages) & 1) ^ 1);
          mbar_expect_tx(&vfull[s], kTile * 2);
          tma_load_4d(Vs + s * kTile, &tv, &vfull[s], 0, head, j * kBKey, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(S::kConsumerRegs));
  const int c = wg - 1;  // which 64 queries of the item
  const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const uint64_t dk0 = desc_sw128(Ks);
  const uint64_t dv0 = desc_sw128(Vs);
  constexpr uint64_t kTileDesc = (kTile * 2) >> 4;  // one tile, desc units
  constexpr uint64_t kRowsDesc = (16 * kD * 2) >> 4;  // 16 rows of V

  int vc = 0;  // V tiles consumed so far (the ring's position)
  for (int it = blockIdx.x, li = 0; it < items; it += gridDim.x, ++li) {
    int bh, q0;
    item(it, bh, q0);
    const int kpar = li & 1;  // phase of this item's q and K barriers
    mbar_wait(qfull, kpar);
    if (q0 + c * 64 >= N) {
      // no query of this warpgroup: keep the barriers' counts only
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(qempty);
      for (int j = 0; j < nkt; ++j) {
        mbar_wait(&kfull[j], kpar);
        if (tid == 0) mbar_arrive(&kempty[j]);
      }
      for (int j = 0; j < nkt; ++j, ++vc) {
        mbar_wait(&vfull[vc % kVStages], (vc / kVStages) & 1);
        if (tid == 0) mbar_arrive(&vempty[vc % kVStages]);
      }
      continue;
    }

    // q pre-scaled in bfloat16, read from the swizzled tile straight into
    // the A fragments of q.k^T: qf[kk] holds rows g, g + 8 at columns
    // 16 kk + 2 t4 (+ 8) of the warp's 16 rows
    uint32_t qf[4][4];
    {
      const unsigned char* qt =
          reinterpret_cast<const unsigned char*>(Qs + c * 64 * kD);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = warp * 16 + g + 8 * (i & 1);
          const int col = 16 * kk + 2 * t4 + 8 * (i >> 1);
          const uint32_t raw = *reinterpret_cast<const uint32_t*>(
              qt + row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&raw);
          qf[kk][i] = pack_bf16(__low2float(v) * scale, __high2float(v) * scale);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(qempty);

    float sa[32], sb[32];
    auto scores = [&](float (&s)[32], int j) {
      issue_scores(s, qf, dk0 + j * kTileDesc);
    };

    // pass 1: running max and sum, the next tile's scores in flight
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    auto stats = [&](float (&s)[32], int j) {
      if ((j + 1) * kBKey > N) mask_tail(s, j * kBKey, N, t4);
      row_stats(s, m, l);
    };
    mbar_wait(&kfull[0], kpar);
    scores(sa, 0);
    int j = 0;
    for (; j + 2 < nkt; j += 2) {
      mbar_wait(&kfull[j + 1], kpar);
      scores(sb, j + 1);
      wgmma_wait<1>();
      fence_regs(sa);
      stats(sa, j);
      mbar_wait(&kfull[j + 2], kpar);
      scores(sa, j + 2);
      wgmma_wait<1>();
      fence_regs(sb);
      stats(sb, j + 1);
    }
    if (j + 1 < nkt) {
      mbar_wait(&kfull[j + 1], kpar);
      scores(sb, j + 1);
      wgmma_wait<1>();
      fence_regs(sa);
      stats(sa, j);
      wgmma_wait<0>();
      fence_regs(sb);
      stats(sb, j + 1);
    } else {
      wgmma_wait<0>();
      fence_regs(sa);
      stats(sa, j);
    }
    // the row's four threads: true max, and their sums rescaled to it
    float r[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(m[h], __shfl_xor_sync(kFull, m[h], 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      float lt = l[h] * ex2((m[h] - mx) * kLog2e);
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      r[h] = 1.0f / lt;
      ml[h] = mx * kLog2e;
    }

    // pass 2: p rounded to bfloat16 into registers, o += p.V.  The scores
    // of tile j + 1 are in flight while p.V of tile j is issued; the
    // exponentials of tile j + 1 then overlap p.V of tile j and the scores
    // of tile j + 2.  K tile j is let go once its scores are in.
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    uint32_t p[4][4];
    auto to_p = [&](float (&s)[32], int j) {  // scores of tile j -> p
      if (tid == 0) mbar_arrive(&kempty[j]);
      if ((j + 1) * kBKey > N) mask_tail(s, j * kBKey, N, t4);
      probs(s, ml, r);
    };
    auto issue_pv = [&](int j) {
      const int v = vc + j;
      mbar_wait(&vfull[v % kVStages], (v / kVStages) & 1);
      const uint64_t dv = dv0 + (v % kVStages) * kTileDesc;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(o, p[kk], dv + kk * kRowsDesc, 1);
      wgmma_commit();
    };
    auto release_v = [&](int j) {
      fence_regs(p);
      if (tid == 0) mbar_arrive(&vempty[(vc + j) % kVStages]);
    };
    // in flight on entry: the scores of tile j + 1 into cur
    auto step = [&](float (&cur)[32], float (&nxt)[32], int j) {
      issue_pv(j);
      wgmma_wait<1>();
      fence_regs(cur);
      scores(nxt, j + 2);
      to_p(cur, j + 1);
      wgmma_wait<1>();
      release_v(j);
      pack_probs(cur, p);
    };
    auto step_penult = [&](float (&cur)[32], int j) {
      issue_pv(j);
      wgmma_wait<1>();
      fence_regs(cur);
      to_p(cur, j + 1);
      wgmma_wait<0>();
      release_v(j);
      pack_probs(cur, p);
    };
    scores(sa, 0);
    wgmma_wait<0>();
    fence_regs(sa);
    to_p(sa, 0);
    pack_probs(sa, p);
    if (nkt > 1) {
      scores(sb, 1);
      for (j = 0; j + 3 < nkt; j += 2) {
        step(sb, sa, j);
        step(sa, sb, j + 1);
      }
      if (nkt - j == 3) {
        step(sb, sa, j);
        step_penult(sa, j + 1);
      } else {
        step_penult(sb, j);
      }
    }
    issue_pv(nkt - 1);
    wgmma_wait<0>();
    release_v(nkt - 1);
    fence_regs(o);
    vc += nkt;

    const int b = bh / H, head = bh % H;
    const int row0 = q0 + c * 64 + warp * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = row0 + 8 * h;
      if (n >= N) continue;
      __nv_bfloat16* dst =
          out + ((size_t)b * N + n) * H * kD + (size_t)head * kD;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<uint32_t*>(dst + 8 * jn + 2 * t4) =
            pack_bf16(o[4 * jn + 2 * h], o[4 * jn + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__global__ void __launch_bounds__(kFThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int N,
                 int H, long long sb, long long sn, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                      // [64][kFPad]
  float* Ks = Qs + kFQ * kFPad;         // [2][64][kFPad]
  float* Vs = Ks + 2 * kBKey * kFPad;   // [2][64][64]
  float* Ps = Vs + 2 * kBKey * kD;      // [64 keys][kFPad], column ty*4 + a

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, head = blockIdx.y % H;
  const int q0 = blockIdx.x * kFQ;
  const size_t base = (size_t)b * sb + (size_t)head * kD;
  const int nkt = (N + kBKey - 1) / kBKey;

  // stage keys and values [k0, k0 + 64) (zeros past the sequence end)
  auto stage = [&](int j) {
    const int k0 = j * kBKey, buf = j & 1;
    for (int i = tid; i < kBKey * (kD / 4); i += kFThreads) {
      const int r = i / (kD / 4), c4 = (i % (kD / 4)) * 4;
      const bool ok = k0 + r < N;
      const size_t off = ok ? base + (size_t)(k0 + r) * sn + c4 : base;
      cp_async16(Ks + (buf * kBKey + r) * kFPad + c4, k + off, ok);
      cp_async16(Vs + (buf * kBKey + r) * kD + c4, v + off, ok);
    }
    cp_async_commit();
  };
  stage(0);

  // q pre-scaled in float32
  for (int i = tid; i < kFQ * (kD / 4); i += kFThreads) {
    const int r = i / (kD / 4), c4 = (i % (kD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N)
      x = *reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * sn + c4);
    x.x = __fmul_rn(x.x, scale);
    x.y = __fmul_rn(x.y, scale);
    x.z = __fmul_rn(x.z, scale);
    x.w = __fmul_rn(x.w, scale);
    *reinterpret_cast<float4*>(Qs + r * kFPad + c4) = x;
  }

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.0f;
  }
  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      stage(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kb = Ks + (j & 1) * kBKey * kFPad;
    const float* Vb = Vs + (j & 1) * kBKey * kD;
    const int k0 = j * kBKey;

    // scores of queries ty + 16a against keys tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * kFPad + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb[c] = *reinterpret_cast<const float4*>(Kb + (tx + 16 * c) * kFPad + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qa[a].x, kb[c].x, s[a][c]);
          s[a][c] = fmaf(qa[a].y, kb[c].y, s[a][c]);
          s[a][c] = fmaf(qa[a].z, kb[c].z, s[a][c]);
          s[a][c] = fmaf(qa[a].w, kb[c].w, s[a][c]);
        }
    }

    // online softmax: the row's 16 threads (tx) share its max
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (k0 + tx + 16 * c >= N) s[a][c] = -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float mn = fmaxf(m[a], mx);
      const float alpha = ex2((m[a] - mn) * kLog2e);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = ex2((s[a][c] - mn) * kLog2e);
        sum += s[a][c];
      }
      l[a] = l[a] * alpha + sum;
      m[a] = mn;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * c) * kFPad + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // o[a][c] += sum over keys of p[query ty + 16a][key] v[key][4 tx + c]
#pragma unroll 8
    for (int kk = 0; kk < kBKey; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(Ps + kk * kFPad + ty * 4);
      const float4 vb = *reinterpret_cast<const float4*>(Vb + kk * kD + tx * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        o[a][0] = fmaf(pv[a], vb.x, o[a][0]);
        o[a][1] = fmaf(pv[a], vb.y, o[a][1]);
        o[a][2] = fmaf(pv[a], vb.z, o[a][2]);
        o[a][3] = fmaf(pv[a], vb.w, o[a][3]);
      }
    }
    __syncthreads();  // this buffer and Ps are free for the next tile
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float lt = l[a];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) lt += __shfl_xor_sync(kFull, lt, off);
    const int n = q0 + ty + 16 * a;
    if (n >= N) continue;
    const float rl = 1.0f / lt;
    float* dst = out + ((size_t)b * N + n) * H * kD + (size_t)head * kD + tx * 4;
    *reinterpret_cast<float4*>(dst) =
        make_float4(o[a][0] * rl, o[a][1] * rl, o[a][2] * rl, o[a][3] * rl);
  }
}

// One head's rows of q, k or v inside the qkv projection: dims (64, H, N,
// B) with strides (1, 64, sn, sb) elements; boxes of ``rows`` tokens of one
// head, 128-byte swizzle, zeros past the sequence end.
bool head_map(CUtensorMap* map, const void* ptr, int B, int N, int H,
              long long sb, long long sn, int rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kD * 2, (cuuint64_t)sn * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One CTA per SM (fewer when there are fewer items) walks the items
// (batch.head, 64 kCW queries) in order.
template <int kCW>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        int B, int N, int H, long long sb, long long sn,
                        float scale, int ctas, cudaStream_t st) {
  using S = Shape<kCW>;
  const int nkt = (N + kBKey - 1) / kBKey;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B, N, H, sb, sn, S::kBQ) ||
      !head_map(&tk, k, B, N, H, sb, sn, kBKey) ||
      !head_map(&tv, v, B, N, H, sb, sn, kBKey))
    return cudaErrorNotSupported;
  const int smem = 1024 + (S::kBQ * kD + (kVStages + nkt) * kTile) * 2 +
                   (2 + 2 * S::kMaxKeyTiles + 2 * kVStages) *
                       (int)sizeof(uint64_t);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<kCW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  flash_bf16_kernel<kCW><<<ctas, S::kThreads, smem, st>>>(
      tq, tk, tv, (__nv_bfloat16*)out, N, H, B * H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: one head's rows at q + b * sb + n * sn + h * 64 (elements), the
// 64 values of a row contiguous, bfloat16 (is_bf16 = 1) or float32; out:
// (B, N, H, 64) contiguous, same type; scale already rounded to that type.
// Requires 16-byte aligned pointers, strides that are multiples of 8
// elements and, in bfloat16, N <= 1408 (the head's K stays in shared
// memory).  Returns cudaGetLastError(), or cudaErrorNotSupported when the
// driver gives no tensor-map encoder.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int N, int H, long long sb,
                                 long long sn, float scale, int is_bf16,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    if ((N + kBKey - 1) / kBKey > kMaxKeyTiles)
      return (int)cudaErrorInvalidValue;
    // Three consumer warpgroups hide the softmax's latencies better than
    // two; two cut the work into finer items, so the last round of items
    // leaves fewer SMs idle.  Take three unless two need fewer
    // warpgroup-rounds (rounds of items over the SMs, times the
    // warpgroups of an item).
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    auto items = [&](int cw) { return B * H * ((N + 64 * cw - 1) / (64 * cw)); };
    auto cost = [&](int cw) { return (items(cw) + sms - 1) / sms * cw; };
    auto ctas = [&](int cw) { return items(cw) < sms ? items(cw) : sms; };
    err = cost(3) <= cost(2)
              ? launch_bf16<3>(q, k, v, out, B, N, H, sb, sn, scale, ctas(3), st)
              : launch_bf16<2>(q, k, v, out, B, N, H, sb, sn, scale, ctas(2), st);
    return (int)err;
  } else {
    const int smem =
        (kFQ * kFPad + 2 * kBKey * kFPad + 2 * kBKey * kD + kBKey * kFPad) *
        (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + kFQ - 1) / kFQ, B * H);
    flash_f32_kernel<<<grid, kFThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, N, H,
        sb, sn, scale);
  }
  return (int)cudaGetLastError();
}
