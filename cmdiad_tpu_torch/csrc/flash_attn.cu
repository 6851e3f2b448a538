// Fused multi-head self-attention, softmax(q.k^T).v per (batch, head).
//
// Replaces the TPU kernel cmdiad_tpu/ops/flash_attn.py:_attn_kernel
// (reached through fused_attention with use_flash=True, and at float32 also
// without it: see the float32 design below).  Semantics, as there: q
// arrives pre-scaled in the compute dtype; scores are products of
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
// float32 design (the route of every float32 call at head dim 64 on the
// card, ops/flash_attn.py): plain FFMA, no TF32, bfloat16 or 3xTF32, and one
// pass with an online softmax in float32 m, l and o.  Rounding the
// normalised p to float32 is the identity, so o / l differs from the
// two-pass form, and from the einsum form, by float32 summation order and
// by ex2.approx (about 2 ulp, denormals flushed) where they take expf.
//   * What bounds it: the FFMA rate, 2 N^2 64 FMAs a (batch, head) at 67
//     TFLOP/s (0.923 ms at B 8 x 16 heads x 1374, 0.226 at 8 x 12 x 785,
//     0.192 at 8 x 6 x 1024), and with it shared memory, which hands an SM
//     32 floats a clock against 128 FMAs: a register tile must turn every
//     float a thread reads into four FMAs to keep up, broadcasts included.
//   * A CTA of four warps takes 128 queries of one (batch, head); a warp
//     owns 32 of them, a lane 8 rows x 8 keys of each 64-key tile of S and
//     8 rows x 8 head dims of O, so that both products read one float for
//     four FMAs (LDS.128 along the head dim for q.k^T, along queries and
//     head dims for p.V).  Q and K rows are swizzled by 16-byte chunk so
//     that the lanes' reads of one column hit eight bank groups.
//   * K and V stream through a two-slot ring by cp.async, reading the
//     (B, N, 3, H, 64) projection in place through its strides: tile j + 1
//     lands while tile j is worked on, one CTA barrier a tile.
//   * p goes from the S layout to the p.V layout through the warp's own
//     shared buffer, 32 keys at a time: warp barriers, no CTA barrier.  A
//     row's max is shared by its eight key lanes through shuffles; each
//     lane keeps its part of the sum, added once at the end, and the output
//     takes one reciprocal a row.  Exponentials are ex2.approx of
//     log2 e-scaled scores, one FFMA each.
//   * 254 registers (222 with the split below) and 112 KB of shared
//     memory: two CTAs (eight warps) an SM.  Where the 128-query grid is short of three rounds of two CTAs an
//     SM (batch 1, and ViT-B/8's 785 tokens at batch 8), a CTA takes 64
//     queries and each pair of warps splits every key tile, 32 keys each (8
//     rows x 4 keys of S a lane), merging their m, l and o at the end: twice
//     the warps for the same work.  A CTA of fewer warps measured slower at
//     every shape: the ring caps an SM at two CTAs.  O is written as
//     (B, N, H, 64), which proj reads as it is.

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

// float32 kernel: a CTA of four warps; each owns 32 queries and all of each
// key tile's 64 keys, or (kSplit = 2) half of them, its partner warp the
// other half
constexpr int kFW = 4;               // warps a CTA
constexpr int kWarpQ = 32;           // queries a warp
constexpr int kFThreads = 32 * kFW;
constexpr int kPKeys = 32;           // keys of p a warp hands over at a time
constexpr int kTileF = kBKey * kD;   // floats of a K or V tile

template <int kSplit>
struct F32Shape {
  static constexpr int kBQ = kFW / kSplit * kWarpQ;  // queries a CTA
  static constexpr int kKeys = kBKey / kSplit;       // a warp's keys a tile
  // q, the two-slot K and V ring and each warp's p: 112 KB at kSplit = 1,
  // so that two CTAs share an SM
  static constexpr int kSmem =
      (kBQ * kD + 4 * kTileF + kFW * kPKeys * kWarpQ) * (int)sizeof(float);
};

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

// Float offset of 16-byte chunk c of row r in a shared tile whose rows
// hold kChunks chunks, the chunk index's low three bits XORed with the
// row's: eight consecutive rows read at one column hit eight bank groups.
template <int kChunks>
__device__ __forceinline__ int swz(int r, int c) {
  return r * kChunks * 4 + ((c ^ (r & 7)) << 2);
}

__device__ __forceinline__ float4 lds128(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float x, float y, float z,
                                       float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}

// Warp w owns queries q0 + 32 g .. + 31 of its group g = w / kSplit; lane
// (ty, tx) = (lane / 8, lane % 8) owns rows ty + 4 a (a < 8) of them; in S
// keys kKeys p + tx + 8 c (c < kKeys / 8) of each 64-key tile, p = w %
// kSplit its part; in O head dims 4 tx .. + 3 and 32 + 4 tx .. + 3.
//
// Shared memory, in floats (Q and K rows 16-byte-chunk swizzled):
//   Q [kBQ][64]               q pre-scaled, written once
//   K [2][64 keys][64]        the ring, cp.async of 16 bytes
//   V [2][64 keys][64]
//   P [4][32 keys][32 q]      a warp's p, slot 8 ty + a holding row ty + 4 a
template <int kSplit>
__global__ void __launch_bounds__(kFThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int N,
                 int H, long long sb, long long sn, float scale) {
  using S = F32Shape<kSplit>;
  constexpr int kBQ = S::kBQ, kKeys = S::kKeys, kC = kKeys / 8;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + kBQ * kD;
  float* Vs = Ks + 2 * kTileF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 7, ty = lane >> 3;
  const int grp = warp / kSplit, part = warp % kSplit;
  float* Pw = Vs + 2 * kTileF + warp * kPKeys * kWarpQ;
  const int qr = grp * kWarpQ + ty;      // the thread's row a is qr + 4 a

  const int b = blockIdx.y / H, head = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)b * sb + (size_t)head * kD;
  const int nkt = (N + kBKey - 1) / kBKey;

  // keys and values [k0, k0 + 64) into ring slot j % 2, zeros past the end
  auto stage = [&](int j) {
    const int k0 = j * kBKey;
    float* kd = Ks + (j & 1) * kTileF;
    float* vd = Vs + (j & 1) * kTileF;
#pragma unroll
    for (int it = 0; it < kTileF / 4 / kFThreads; ++it) {
      const int i = tid + it * kFThreads, r = i >> 4, c = i & 15;
      const bool ok = k0 + r < N;
      const size_t off = ok ? base + (size_t)(k0 + r) * sn + 4 * c : base;
      cp_async16(kd + swz<16>(r, c), k + off, ok);
      cp_async16(vd + r * kD + 4 * c, v + off, ok);
    }
    cp_async_commit();
  };
  stage(0);

  // q pre-scaled in float32, as the einsum form scales it
#pragma unroll 4
  for (int it = 0; it < kBQ * (kD / 4) / kFThreads; ++it) {
    const int i = tid + it * kFThreads, r = i >> 4, c = i & 15;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N)
      x = *reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * sn + 4 * c);
    store4(Qs + swz<16>(r, c), __fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
           __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
  }

  float o[8][8], m[8], l[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[a][e] = 0.0f;
  }
  for (int j = 0; j < nkt; ++j) {
    // tile j is in and every warp is done with tile j - 1: its slot takes
    // tile j + 1, which lands while this tile is worked on
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nkt) stage(j + 1);
    const float* Kb = Ks + (j & 1) * kTileF + part * kKeys * kD;
    const float* Vb = Vs + (j & 1) * kTileF + part * kKeys * kD;

    // S = q . k^T: each chunk of four head dims is kC + 8 LDS.128 for
    // 32 kC FMAs (at kSplit = 1 four FMAs a float read)
    float s[8][kC];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < kC; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int dc = 0; dc < kD / 4; ++dc) {
      float4 kf[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) kf[c] = lds128(Kb + swz<16>(tx + 8 * c, dc));
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float4 qa = lds128(Qs + swz<16>(qr + 4 * a, dc));
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          s[a][c] = fmaf(qa.x, kf[c].x, s[a][c]);
          s[a][c] = fmaf(qa.y, kf[c].y, s[a][c]);
          s[a][c] = fmaf(qa.z, kf[c].z, s[a][c]);
          s[a][c] = fmaf(qa.w, kf[c].w, s[a][c]);
        }
      }
    }

    // online softmax: a row's eight key lanes share its max; each keeps
    // its own part of the sum, rescaled with the row's max
    const int k0 = j * kBKey + part * kKeys;
    if (k0 + kKeys > N) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (k0 + tx + 8 * c >= N)
#pragma unroll
          for (int a = 0; a < 8; ++a) s[a][c] = -INFINITY;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float mx = s[a][0];
#pragma unroll
      for (int c = 1; c < kC; ++c) mx = fmaxf(mx, s[a][c]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      // a warp whose keys all lie past the sequence end so far keeps
      // m = -inf, l = 0 and o = 0 (only at kSplit = 2)
      const float mn = fmaxf(m[a], mx), mnl = mn == -INFINITY ? 0.0f : mn * kLog2e;
      const float alpha = ex2(fmaf(m[a], kLog2e, -mnl));  // 0 on the first tile
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s[a][c] = ex2(fmaf(s[a][c], kLog2e, -mnl));
        sum += s[a][c];
      }
      l[a] = fmaf(l[a], alpha, sum);
      m[a] = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[a][e] *= alpha;
    }

    // O += p . V, 32 keys at a time: the warp's lanes hand p over through
    // its own shared buffer (a warp barrier, no CTA barrier); each key is
    // 2 + 2 LDS.128 for 64 FMAs
#pragma unroll
    for (int h = 0; h < kKeys / kPKeys; ++h) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 8 * c, sc = 4 * h + c;
        store4(Pw + swz<8>(key, 2 * ty), s[0][sc], s[1][sc], s[2][sc], s[3][sc]);
        store4(Pw + swz<8>(key, 2 * ty + 1), s[4][sc], s[5][sc], s[6][sc],
               s[7][sc]);
      }
      __syncwarp();
      const float* Vh = Vb + h * kPKeys * kD;
#pragma unroll 4
      for (int kk = 0; kk < kPKeys; ++kk) {
        const float4 p0 = lds128(Pw + swz<8>(kk, 2 * ty));
        const float4 p1 = lds128(Pw + swz<8>(kk, 2 * ty + 1));
        const float4 v0 = lds128(Vh + kk * kD + 4 * tx);
        const float4 v1 = lds128(Vh + kk * kD + 32 + 4 * tx);
        const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e) o[a][e] = fmaf(p[a], vv[e], o[a][e]);
      }
      __syncwarp();
    }
  }

  // the row's sum over its eight key lanes
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    l[a] += __shfl_xor_sync(kFull, l[a], 1);
    l[a] += __shfl_xor_sync(kFull, l[a], 2);
    l[a] += __shfl_xor_sync(kFull, l[a], 4);
  }
  if constexpr (kSplit == 2) {
    // the second warp of a group hands its m, l and o to the first through
    // the (now idle) K ring, which rescales both to the larger max
    __syncthreads();
    float* X = Ks + grp * kWarpQ * (kD + 2);  // [32 rows][m, l, 64 o]
    if (part == 1) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        float* xr = X + (ty + 4 * a) * (kD + 2);
        if (tx == 0) {
          xr[0] = m[a];
          xr[1] = l[a];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xr[2 + 4 * tx + e] = o[a][e];
          xr[2 + 32 + 4 * tx + e] = o[a][4 + e];
        }
      }
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float* xr = X + (ty + 4 * a) * (kD + 2);
      const float m1 = xr[0], mx = fmaxf(m[a], m1), mxl = mx * kLog2e;
      const float a0 = ex2(fmaf(m[a], kLog2e, -mxl));
      const float a1 = ex2(fmaf(m1, kLog2e, -mxl));
      l[a] = fmaf(l[a], a0, xr[1] * a1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[a][e] = fmaf(o[a][e], a0, xr[2 + 4 * tx + e] * a1);
        o[a][4 + e] = fmaf(o[a][4 + e], a0, xr[2 + 32 + 4 * tx + e] * a1);
      }
    }
  }

  // one reciprocal a row
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int n = q0 + qr + 4 * a;
    if (n >= N) continue;
    const float rl = 1.0f / l[a];
    float* dst = out + ((size_t)b * N + n) * H * kD + (size_t)head * kD + 4 * tx;
    store4(dst, o[a][0] * rl, o[a][1] * rl, o[a][2] * rl, o[a][3] * rl);
    store4(dst + 32, o[a][4] * rl, o[a][5] * rl, o[a][6] * rl, o[a][7] * rl);
  }
}

// One CTA per (batch.head, 128 / kSplit queries); two share an SM.
template <int kSplit>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int N, int H, long long sb, long long sn,
                       float scale, cudaStream_t st) {
  using S = F32Shape<kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_f32_kernel<kSplit>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + S::kBQ - 1) / S::kBQ, B * H);
  flash_f32_kernel<kSplit><<<grid, kFThreads, S::kSmem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, N, H,
      sb, sn, scale);
  return cudaGetLastError();
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
  if (is_bf16) {
    if ((N + kBKey - 1) / kBKey > kMaxKeyTiles)
      return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // Three consumer warpgroups hide the softmax's latencies better than
    // two; two cut the work into finer items, so the last round of items
    // leaves fewer SMs idle.  Take three unless two need fewer
    // warpgroup-rounds (rounds of items over the SMs, times the
    // warpgroups of an item).
    auto items = [&](int cw) { return B * H * ((N + 64 * cw - 1) / (64 * cw)); };
    auto cost = [&](int cw) { return (items(cw) + sms - 1) / sms * cw; };
    auto ctas = [&](int cw) { return items(cw) < sms ? items(cw) : sms; };
    return (int)(cost(3) <= cost(2)
        ? launch_bf16<3>(q, k, v, out, B, N, H, sb, sn, scale, ctas(3), st)
        : launch_bf16<2>(q, k, v, out, B, N, H, sb, sn, scale, ctas(2), st));
  }
  // 128 queries a CTA, every warp on all keys of a tile, where that grid
  // fills three or more rounds of two CTAs an SM; else 64, each warp pair
  // splitting every tile's keys, whose finer grid leaves less of the last
  // round idle and, at batch 1, gives each SM work (measured, PERF.md §6)
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ctas =
      (long long)B * H * ((N + F32Shape<1>::kBQ - 1) / F32Shape<1>::kBQ);
  return (int)(ctas >= 3 * 2 * sms
      ? launch_f32<1>(q, k, v, out, B, N, H, sb, sn, scale, st)
      : launch_f32<2>(q, k, v, out, B, N, H, sb, sn, scale, st));
}
