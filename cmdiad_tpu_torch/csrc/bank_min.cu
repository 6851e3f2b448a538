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

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// 2-D TMA load of the box at (c0 = column, c1 = row) into shared memory,
// completing on ``bar``.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile whose rows are 128 bytes, written by
// TMA with the 128-byte swizzle: 8-row groups 1024 bytes apart.  Stepping
// 16 columns (32 bytes) along K adds 2 to the start address field.
__device__ __forceinline__ uint64_t desc_k_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D (64 x 256, f32) = scale_d * D + A (64 x 16) . B (256 x 16)^T, both
// operands bfloat16 in shared memory (K-major).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
        const uint64_t da = desc_k_sw128(a), db = desc_k_sw128(b);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, D) bfloat16 row-major, boxes of box_rows x 64 columns, 128-byte
// swizzle, zeros past the last row.
bool row_map(CUtensorMap* map, const void* ptr, int rows, int D,
             int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  CUtensorMap tq, tb;
  if (!row_map(&tq, q, NQ, D, kBM) || !row_map(&tb, bank, NB, D, kBN))
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
