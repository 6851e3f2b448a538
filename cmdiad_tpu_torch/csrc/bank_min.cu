// Memory-bank min/argmin with a bfloat16 cross term on the tensor cores.
//
// Replaces the TPU kernel cmdiad_tpu/ops/pallas_scoring.py:_kernel (reached
// through bank_min_dist_pallas).  For every query row q it returns
//   min over bank rows b of  |b|^2 - 2 b.q   and the row that attains it,
// with b.q taken over operands rounded to bfloat16 and summed in float32,
// |b|^2 exact float32 (passed in), and ties going to the lowest row index.
// The caller adds |q|^2 and recomputes the chosen row's distance exactly in
// float32 (the TPU package's refine step), so the bfloat16 product only
// chooses the row.
//
// What bounds it on the card: the cross term, 2 * Nq * Nb * D operations
// in bfloat16 (2.58 TFLOP for 25088 queries against 65536 rows of 768;
// 2.6 ms at the 989 TFLOP/s dense peak), far above the bytes it must move.
//
// Design: a GEMM with a fused row-min epilogue, tiled in two dimensions.
//   * Output tiles of 128 queries x 256 bank rows, the 768 columns in steps
//     of 64.  Both operands arrive by TMA (128-byte swizzle) in a 4-stage
//     shared-memory ring that one producer thread keeps full; two consumer
//     warpgroups, 64 queries each, run wgmma m64n256k16 (bf16 in, f32
//     accumulate) on the stage that has arrived, one step of wgmma kept in
//     flight while the previous stage is released.  setmaxnreg moves
//     registers from the producer to the consumers' 128 accumulators.
//   * Persistent CTAs, one per SM, walk the tiles in groups of 16 query
//     tiles: the CTAs in flight at once share the same few bank tiles and
//     the same 16 query tiles in L2.
//   * Epilogue: each thread folds its accumulator columns into a running
//     (value, row) per query row with |b|^2 - 2 acc and a strict '<' over
//     rows in increasing order; the four threads of a row combine theirs,
//     lower row winning ties; one thread then publishes the row's result as
//     a 64-bit key (ordered float bits << 32 | row) with atomicMin.  Signed
//     order of the keys is lexicographic (value, row) order, so the minimum
//     is the first occurrence of the minimum value whatever order the CTAs
//     run in, and the result is deterministic.  -0.0 is made +0.0 first:
//     the strict '<' treats them as equal.
// Queries past NQ and bank rows past NB read as zeros (TMA's out-of-bounds
// fill) and are masked in the epilogue.  The caller fills the keys with
// INT64_MAX and unpacks them (ops/bank_min.py).

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;     // queries per tile (64 per consumer warpgroup)
constexpr int kBN = 256;     // bank rows per tile
constexpr int kBK = 64;      // columns per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kGroupQ = 16;  // query tiles per group of the tile order
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kStageA = kBM * kBK;  // bf16 elements per stage
constexpr int kStageB = kBN * kBK;
constexpr unsigned kFull = 0xffffffffu;

// Signed 64-bit key whose order is (value, row) order: the float's bits
// with the magnitude flipped for negative values, above the row.
__device__ __forceinline__ long long min_key(float v, int row) {
  const int b = __float_as_int(v + 0.0f);  // -0.0 -> +0.0
  const int o = b < 0 ? b ^ 0x7fffffff : b;
  return (long long)(((unsigned long long)(unsigned)o << 32) | (unsigned)row);
}

__global__ void __launch_bounds__(kThreads, 1)
bank_min_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tb,
                const float* __restrict__ bnorm, int NQ, int NB, int D,
                long long* __restrict__ keys) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sB = sA + kStages * kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kStages * kStageB);
  uint64_t* empty = full + kStages;

  const int nqb = (NQ + kBM - 1) / kBM, nbb = (NB + kBN - 1) / kBN;
  const int ntiles = nqb * nbb, nk = D / kBK;
  const int group = kGroupQ * nbb;
  auto tile_coords = [&](int t, int& qb, int& bb) {
    const int first = (t / group) * kGroupQ;
    const int gq = min(nqb - first, kGroupQ);
    const int r = t % group;
    qb = first + r % gq;
    bb = r / gq;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0, phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int qb, bb;
        tile_coords(t, qb, bb);
        for (int k = 0; k < nk; ++k) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], (kStageA + kStageB) * 2);
          tma_load_2d(sA + s * kStageA, &tq, &full[s], k * kBK, qb * kBM);
          tma_load_2d(sB + s * kStageB, &tb, &full[s], k * kBK, bb * kBN);
          if (++s == kStages) { s = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;  // 64-query half of the tile
    const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[128];
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int qb, bb;
      tile_coords(t, qb, bb);
      int prev = -1;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&full[s], phase);
        const __nv_bfloat16* a = sA + s * kStageA + cw * 64 * kBK;
        const __nv_bfloat16* b = sB + s * kStageB;
        const uint64_t da = desc_sw128(a), db = desc_sw128(b);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        wgmma_commit();
        // the step before this one is done: release its stage
        wgmma_wait<1>();
        if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");

      // epilogue: acc[4j + 2h + e] is query row g + 8h of this warp's 16,
      // bank row 8j + 2 t4 + e of the tile
      float bv[2] = {INFINITY, INFINITY};
      int bi[2] = {0, 0};
      const int c0 = bb * kBN + 2 * t4;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = c0 + 8 * j;
        float2 bn = make_float2(INFINITY, INFINITY);
        if (c < NB) bn = __ldg(reinterpret_cast<const float2*>(bnorm + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = fmaf(-2.0f, acc[4 * j + 2 * h], bn.x);
          const float v1 = fmaf(-2.0f, acc[4 * j + 2 * h + 1], bn.y);
          if (v0 < bv[h]) { bv[h] = v0; bi[h] = c; }
          if (v1 < bv[h]) { bv[h] = v1; bi[h] = c + 1; }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = bv[h];
        int i = bi[h];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(kFull, v, off);
          const int oi = __shfl_xor_sync(kFull, i, off);
          if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
        }
        const int row = qb * kBM + cw * 64 + warp * 16 + g + 8 * h;
        if (t4 == 0 && row < NQ) atomicMin(&keys[row], min_key(v, i));
      }
    }
  }
}

}  // namespace

// q: (NQ, D) bfloat16; bank: (NB, D) bfloat16; bnorm: (NB,) float32 exact
// squared row norms; keys: (NQ,) int64 filled with INT64_MAX, where the
// kernel leaves min_key(min of |b|^2 - 2 b.q, argmin) per query.  Requires
// NB % 64 == 0, D % 64 == 0 and 16-byte aligned pointers.  Returns
// cudaGetLastError(), or cudaErrorNotSupported when the driver gives no
// tensor-map encoder.
extern "C" int bank_min_launch(const void* q, const void* bank,
                               const void* bnorm, int NQ, int NB, int D,
                               void* keys, void* stream) {
  // (rows, D) bfloat16, boxes of rows x 64 columns, zeros past the last row
  CUtensorMap tq, tb;
  if (!matrix_map_sw128(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, NQ, D, kBM,
                        kBK) ||
      !matrix_map_sw128(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bank, NB, D,
                        kBN, kBK))
    return (int)cudaErrorNotSupported;
  const int smem = 1024 + kStages * (kStageA + kStageB) * 2 +
                   2 * kStages * (int)sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      bank_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ntiles = ((NQ + kBM - 1) / kBM) * ((NB + kBN - 1) / kBN);
  const int grid = ntiles < sms ? ntiles : sms;
  bank_min_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      tq, tb, (const float*)bnorm, NQ, NB, D, (long long*)keys);
  return (int)cudaGetLastError();
}
