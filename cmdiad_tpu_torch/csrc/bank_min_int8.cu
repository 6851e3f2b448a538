// Memory-bank min/argmin with an int8 cross term on the tensor cores.
//
// Replaces the TPU kernel cmdiad_tpu/ops/pallas_scoring.py:_kernel_int8
// (reached through _bank_min_dist_int8, cfg.dist_method_s = 'l2_int8').
// Queries and bank rows arrive quantised per row to int8 with float32
// scales (ops/bank_min.py quantize_rows).  For every query row q it returns
//   min over bank rows b of  |b|^2 - 2 * float(q8.b8) * (bscale * qscale)
// and the row that attains it, ties going to the lowest row index.  The
// s8.s8 -> s32 product is exact; the dequantise steps are rounded one
// operation at a time in the plain version's order (s = bscale * qscale,
// p = float(acc) * s, then |b|^2 - 2p as one fmaf, 2p being exact), so
// kernel and plain version agree bit for bit, values and indices.  The
// caller adds |q|^2 and recomputes the chosen row's distance exactly in
// float32.
//
// What bounds it on the card: the cross term, 2 * Nq * Nb * D int8
// operations (2.525 TOP for 25088 queries against 65536 rows of 768;
// 1.276 ms at the 1979 TOP/s dense int8 peak), well above the bytes it must
// move.
//
// Design: the bf16 bank-min's GEMM (csrc/bank_min.cu) with the probe's
// int8 main loop (csrc/int8_dot.cu).
//   * Output tiles of 128 queries x 256 bank rows; the columns in stages of
//     128 (one 128-byte swizzle row), so a 768-wide row is 6 stages.  Both
//     operands arrive by TMA in a 4-stage ring (16 KB + 32 KB a stage) that
//     one producer thread keeps full; two consumer warpgroups, 64 queries
//     each, run wgmma m64n256k32 (s8 in, s32 accumulate); setmaxnreg moves
//     registers from the producer to the consumers' 128 accumulators.
//     Persistent CTAs walk the tiles in groups of 16 query tiles.
//   * Epilogue: each thread folds its accumulator columns into a running
//     (value, row) per query row, rows in increasing order with a strict
//     '<'; the four threads of a row combine theirs, lower row winning
//     ties; one thread publishes the row's result as a 64-bit key (ordered
//     float bits << 32 | row) with atomicMin, so the result is the first
//     row of the minimum whatever order the CTAs run in.  -0.0 is made
//     +0.0 first.  Per column pair the bank's scale and norm come in one
//     float2 load each; a thread's two query scales stay in registers.
//   * With D = 768 the main loop is only 6 stages, so the fold (convert,
//     two multiplies, an FMA, a compare and two selects per element) is a
//     larger share of a tile than in the bf16 kernel, and the two
//     warpgroups fold together while the tensor cores wait.  Yet on the
//     H100 neither the fold nor the loads set the time: the second
//     warpgroup started two stages behind, so that each folds while the
//     other multiplies, and the ring loaded only once (the `reload` timing
//     aid) each came within 7 % of this design (PERF.md, PR 5).  The main
//     loop does, at about half the int8 peak.
// Queries past NQ and bank rows past NB read as zeros (TMA's out-of-bounds
// fill) and are masked in the epilogue.  The launcher fills the keys with
// INT64_MAX before and unpacks them after, in two small kernels of its own.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;     // queries per tile (64 per consumer warpgroup)
constexpr int kBN = 256;     // bank rows per tile
constexpr int kBK = 128;     // int8 columns per stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kGroupQ = 16;  // query tiles per group of the tile order
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kStageA = kBM * kBK;  // bytes per stage
constexpr int kStageB = kBN * kBK;
constexpr int kSmem = 1024 + kStages * (kStageA + kStageB) +
                      2 * kStages * (int)sizeof(uint64_t);
constexpr unsigned kFull = 0xffffffffu;

// Signed 64-bit key whose order is (value, row) order: the float's bits
// with the magnitude flipped for negative values, above the row.
__device__ __forceinline__ long long min_key(float v, int row) {
  const int b = __float_as_int(v + 0.0f);  // -0.0 -> +0.0
  const int o = b < 0 ? b ^ 0x7fffffff : b;
  return (long long)(((unsigned long long)(unsigned)o << 32) | (unsigned)row);
}

__global__ void __launch_bounds__(kThreads, 1)
bank_min_int8_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tb,
                     const float* __restrict__ qscale,
                     const float* __restrict__ bscale,
                     const float* __restrict__ bnorm, int NQ, int NB, int D,
                     long long* __restrict__ keys, int reload) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sB = sA + kStages * kStageA;
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
      int s = 0, phase = 0, n = 0;
      for (int t = blockIdx.x; t < ntiles && (reload || n < kStages);
           t += gridDim.x) {
        int qb, bb;
        tile_coords(t, qb, bb);
        for (int k = 0; k < nk && (reload || n < kStages); ++k, ++n) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], kStageA + kStageB);
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
    int n = 0;  // stages consumed
    int acc[128];
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int qb, bb;
      tile_coords(t, qb, bb);
      const int row0 = qb * kBM + cw * 64 + warp * 16 + g;
      const float qs[2] = {row0 < NQ ? __ldg(qscale + row0) : 0.0f,
                           row0 + 8 < NQ ? __ldg(qscale + row0 + 8) : 0.0f};
      int prev = -1;
      for (int k = 0; k < nk; ++k, ++n) {
        if (reload || n < kStages) mbar_wait(&full[s], phase);
        const uint64_t da = desc_sw128(sA + s * kStageA + cw * 64 * kBK);
        const uint64_t db = desc_sw128(sB + s * kStageB);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_m64n256k32(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        wgmma_commit();
        // the step before this one is done: release its stage
        wgmma_wait<1>();
        if (reload && prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      if (reload && tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(acc[i]) :: "memory");

      // epilogue: acc[4j + 2h + e] is query row g + 8h of this warp's 16,
      // bank row 8j + 2 t4 + e of the tile
      float bv[2] = {INFINITY, INFINITY};
      int bi[2] = {0, 0};
      const int c0 = bb * kBN + 2 * t4;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = c0 + 8 * j;
        float2 bn = make_float2(INFINITY, INFINITY), bs = make_float2(0.f, 0.f);
        if (c < NB) {
          bn = __ldg(reinterpret_cast<const float2*>(bnorm + c));
          bs = __ldg(reinterpret_cast<const float2*>(bscale + c));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]),
                                     __fmul_rn(bs.x, qs[h]));
          const float p1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]),
                                     __fmul_rn(bs.y, qs[h]));
          const float v0 = fmaf(-2.0f, p0, bn.x);
          const float v1 = fmaf(-2.0f, p1, bn.y);
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
        const int row = row0 + 8 * h;
        if (t4 == 0 && row < NQ) atomicMin(&keys[row], min_key(v, i));
      }
    }
  }
}

// The launcher's first and last kernels: fill the keys with INT64_MAX, and
// unpack them into (value, row) as ops/bank_min.py:unpack_min_keys does,
// so that a call is one launcher call however small the problem.
__global__ void fill_keys_kernel(long long* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = 0x7fffffffffffffffLL;
}

__global__ void unpack_keys_kernel(const long long* __restrict__ keys,
                                   float* __restrict__ value,
                                   long long* __restrict__ row, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = keys[i];
  const int o = (int)(k >> 32);
  value[i] = __int_as_float(o < 0 ? o ^ 0x7fffffff : o);
  row[i] = k & 0xffffffffLL;
}

}  // namespace

// q: (NQ, D) int8; qscale: (NQ,) float32; bank: (NB, D) int8; bscale,
// bnorm: (NB,) float32 (bnorm the exact squared norms of the unquantised
// rows); keys: (NQ,) int64 scratch; value: (NQ,) float32 min of
// |b|^2 - 2 p; row: (NQ,) int64 argmin.  reload 0 is a timing aid that
// gives wrong results: each CTA loads the ring once and runs every tile's
// main loop on those stages, so that the time is the tensor cores' and the
// fold's with no load to wait for.  Requires NB % 64 == 0, D % 128 == 0 and
// 16-byte aligned pointers.  Returns cudaGetLastError(), or
// cudaErrorNotSupported when the driver gives no tensor-map encoder.
extern "C" int bank_min_int8_launch(const void* q, const void* qscale,
                                    const void* bank, const void* bscale,
                                    const void* bnorm, int NQ, int NB, int D,
                                    void* keys, void* value, void* row,
                                    int reload, void* stream) {
  // (rows, D) int8, boxes of rows x 128 columns, zeros past the last row
  CUtensorMap tq, tb;
  if (!matrix_map_sw128(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, NQ, D, kBM,
                        kBK) ||
      !matrix_map_sw128(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bank, NB, D,
                        kBN, kBK))
    return (int)cudaErrorNotSupported;
  // the attribute and the SM count are read once per device
  static int set_for = -1, sms = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (set_for != dev) {
    const cudaError_t err = cudaFuncSetAttribute(
        bank_min_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    set_for = dev;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int small = (NQ + 255) / 256;
  fill_keys_kernel<<<small, 256, 0, st>>>((long long*)keys, NQ);
  const int ntiles = ((NQ + kBM - 1) / kBM) * ((NB + kBN - 1) / kBN);
  const int grid = ntiles < sms ? ntiles : sms;
  bank_min_int8_kernel<<<grid, kThreads, kSmem, st>>>(
      tq, tb, (const float*)qscale, (const float*)bscale, (const float*)bnorm,
      NQ, NB, D, (long long*)keys, reload);
  unpack_keys_kernel<<<small, 256, 0, st>>>((const long long*)keys,
                                            (float*)value, (long long*)row, NQ);
  return (int)cudaGetLastError();
}
