// Memory-bank min/argmin with an int8 cross term on the tensor cores.
//
// Replaces the TPU kernel cmdiad_tpu/ops/pallas_scoring.py:_kernel_int8
// (reached through _bank_min_dist_int8, cfg.dist_method_s = 'l2_int8').
// Queries and bank rows arrive quantised per row to int8 with float32
// scales (ops/bank_min.py quantize_rows).  For every query row q it returns
//   min over bank rows b of  |b|^2 - 2 * float(q8.b8) * (bscale * qscale)
// and the row that attains it, ties going to the lowest row index.  The
// s8.s8 -> s32 product is exact; the dequantise step and the subtraction
// are rounded one operation at a time (__fmul_rn/__fsub_rn, so no FMA
// contraction) in the plain version's order, so kernel and plain version
// agree bit for bit, values and indices.  The caller adds |q|^2 and
// recomputes the chosen row's distance exactly in float32.
//
// What bounds it on the card: the cross term, 2 * Nq * Nb * D int8
// operations (2.525 TOP for 25088 queries against 65536 rows of 768;
// 1.276 ms at the 1979 TOP/s dense int8 peak), well above the bytes it must
// move.
//
// Design, simple first, the structure of bank_min.cu: a block of 4 warps
// owns 64 query rows, kept in shared memory as int8 for the whole run, and
// walks every bank tile of 64 rows in order, staging the tile 128 columns
// at a time.  Each warp computes its 16 x 64 score tile with mma.sync
// m16n8k32 (s8 in, s32 accumulate) and folds it into a running (value,
// row) per query with a strict '<' over rows in increasing order; the four
// threads sharing a query row then combine, the lower row winning ties.
// No cross-block reduction is needed.  Shared-memory rows are padded by
// 16 bytes so the fragment loads are free of bank conflicts.  Not yet done:
// ldmatrix, cp.async/TMA double buffering and wgmma.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block (16 per warp)
constexpr int kBN = 64;        // bank rows per tile
constexpr int kKC = 128;       // int8 columns staged per step
constexpr int kThreads = 128;
constexpr int kBStride = kKC + 16;  // bytes per staged bank row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
bank_min_int8_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ qscale,
                     const int8_t* __restrict__ bank,
                     const float* __restrict__ bscale,
                     const float* __restrict__ bnorm, int NQ, int NB, int D,
                     float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qs_stride = D + 16;
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Bs = Qs + kBQ * qs_stride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;

  const int vec_per_row = D / 16;  // 16-byte vectors per query row
  for (int v = tid; v < kBQ * vec_per_row; v += kThreads) {
    const int r = v / vec_per_row, c = (v % vec_per_row) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < NQ)
      val = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * qs_stride + c) = val;
  }

  const int row0 = q0 + warp * 16 + g;
  const float ps[2] = {row0 < NQ ? qscale[row0] : 0.0f,
                       row0 + 8 < NQ ? qscale[row0 + 8] : 0.0f};
  float best_v[2] = {3.4e38f, 3.4e38f};
  int best_i[2] = {0, 0};
  const int8_t* qa = Qs + (warp * 16) * qs_stride;

  for (int n0 = 0; n0 < NB; n0 += kBN) {
    int acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

    for (int k0 = 0; k0 < D; k0 += kKC) {
      __syncthreads();  // the previous stage is consumed (and Qs is stored)
      for (int v = tid; v < kBN * (kKC / 16); v += kThreads) {
        const int r = v / (kKC / 16), c = (v % (kKC / 16)) * 16;
        *reinterpret_cast<uint4*>(Bs + r * kBStride + c) =
            *reinterpret_cast<const uint4*>(bank + (size_t)(n0 + r) * D + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 32) {
        const int8_t* ap = qa + k0 + ks + t4 * 4;
        uint32_t a[4];
        a[0] = ld32(ap + g * qs_stride);
        a[1] = ld32(ap + (g + 8) * qs_stride);
        a[2] = ld32(ap + g * qs_stride + 16);
        a[3] = ld32(ap + (g + 8) * qs_stride + 16);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int8_t* bp = Bs + (nt * 8 + g) * kBStride + ks + t4 * 4;
          uint32_t bb[2];
          bb[0] = ld32(bp);
          bb[1] = ld32(bp + 16);
          mma_s8(acc[nt], a, bb);
        }
      }
    }

    // dequantise and fold the tile into the running minimum, rows in
    // increasing order: s = bscale * qscale, p = float(prod) * s,
    // d2 = |b|^2 - 2 p, each rounded on its own
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + t4 * 2 + (e & 1);
        const int h = e >> 1;  // 0: query row g, 1: query row g + 8
        const float s = __fmul_rn(bscale[col], ps[h]);
        const float p = __fmul_rn(__int2float_rn(acc[nt][e]), s);
        const float d2 = __fsub_rn(bnorm[col], __fmul_rn(2.0f, p));
        if (d2 < best_v[h]) { best_v[h] = d2; best_i[h] = col; }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best_v[h];
    int i = best_i[h];
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
    }
    const int row = row0 + h * 8;
    if (t4 == 0 && row < NQ) {
      out_v[row] = v;
      out_i[row] = i;
    }
  }
}

}  // namespace

// q: (NQ, D) int8; qscale: (NQ,) float32; bank: (NB, D) int8; bscale,
// bnorm: (NB,) float32 (bnorm the exact squared norms of the unquantised
// rows); out_v: (NQ,) float32 min of |b|^2 - 2 p; out_i: (NQ,) int32
// argmin.  Requires NB % 64 == 0 and D % 128 == 0 (the caller pads the bank
// with far rows).  Returns cudaGetLastError().
extern "C" int bank_min_int8_launch(const void* q, const void* qscale,
                                    const void* bank, const void* bscale,
                                    const void* bnorm, int NQ, int NB, int D,
                                    void* out_v, void* out_i, void* stream) {
  const size_t smem = (size_t)kBQ * (D + 16) + (size_t)kBN * kBStride;
  cudaError_t err = cudaFuncSetAttribute(
      bank_min_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (NQ + kBQ - 1) / kBQ;
  bank_min_int8_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)qscale, (const int8_t*)bank,
      (const float*)bscale, (const float*)bnorm, NQ, NB, D, (float*)out_v,
      (int*)out_i);
  return (int)cudaGetLastError();
}
