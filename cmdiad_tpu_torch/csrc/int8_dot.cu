// Whole-array product on the tensor cores, int8 or bfloat16: a probe.
//
// Replaces the TPU probe kernel benchmarks/probe_int8_dot.py:_kern, which
// asked whether the TPU compiles s8 x s8 -> s32 products and how fast they
// run against bf16 x bf16 -> f32 at the bank kernel's tile shape.  Here it
// asks the same of mma.sync on the card: C = A . B^T with A (M, K) and
// B (N, K), both K-contiguous (the bank-min kernels' layout), C (M, N)
// int32 or float32.
//
// What bounds it on the card: 2 * M * N * K operations (3.2 G at
// 1024 x 768 x 2048; 1.63 us at the 1979 TOP/s int8 peak, 3.26 us at the
// 989 TFLOP/s bf16 peak), above the bytes it moves.
//
// Design: one block of 4 warps per 64 x 64 output tile; A and B tiles of
// 64 rows x 128 bytes are staged in shared memory per step (128 int8 or 64
// bfloat16 columns), so both element types walk the same byte addresses:
// an mma step consumes 32 bytes of K (m16n8k32 s8 or m16n8k16 bf16) and
// the fragments sit at the same byte offsets.  Only the instruction and
// the accumulator differ.  No pipelining: the probe measures mma.sync with
// the simplest staging, as the bank-min kernels use it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kKB = 128;            // bytes of K staged per step
constexpr int kStride = kKB + 16;   // bytes per staged row
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_step(int* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_step(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Acc: int (s8 operands) or float (bf16 operands); kb: row length in bytes.
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const unsigned char* __restrict__ a,
           const unsigned char* __restrict__ b, int N, int kb,
           Acc* __restrict__ c) {
  __shared__ __align__(16) unsigned char As[kBM * kStride];
  __shared__ __align__(16) unsigned char Bs[kBN * kStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  Acc acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = Acc(0);

  const unsigned char* aw = As + (warp * 16) * kStride;
  for (int k0 = 0; k0 < kb; k0 += kKB) {
    __syncthreads();
    for (int v = tid; v < kBM * (kKB / 16); v += kThreads) {
      const int r = v / (kKB / 16), col = (v % (kKB / 16)) * 16;
      *reinterpret_cast<uint4*>(As + r * kStride + col) =
          *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * kb + k0 + col);
      *reinterpret_cast<uint4*>(Bs + r * kStride + col) =
          *reinterpret_cast<const uint4*>(b + (size_t)(n0 + r) * kb + k0 + col);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKB; ks += 32) {
      const unsigned char* ap = aw + ks + t4 * 4;
      uint32_t af[4];
      af[0] = ld32(ap + g * kStride);
      af[1] = ld32(ap + (g + 8) * kStride);
      af[2] = ld32(ap + g * kStride + 16);
      af[3] = ld32(ap + (g + 8) * kStride + 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const unsigned char* bp = Bs + (nt * 8 + g) * kStride + ks + t4 * 4;
        uint32_t bf[2];
        bf[0] = ld32(bp);
        bf[1] = ld32(bp + 16);
        mma_step(acc[nt], af, bf);
      }
    }
  }

  const int row = m0 + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + nt * 8 + t4 * 2;
    c[(size_t)row * N + col] = acc[nt][0];
    c[(size_t)row * N + col + 1] = acc[nt][1];
    c[(size_t)(row + 8) * N + col] = acc[nt][2];
    c[(size_t)(row + 8) * N + col + 1] = acc[nt][3];
  }
}

}  // namespace

// a: (M, K), b: (N, K), both int8 (is_int8 = 1, c int32) or bfloat16
// (is_int8 = 0, c float32); c: (M, N) = a . b^T.  Requires M % 64 == 0,
// N % 64 == 0 and K a multiple of 128 bytes (128 int8 or 64 bfloat16).
// Returns cudaGetLastError().
extern "C" int int8_dot_launch(const void* a, const void* b, void* c, int M,
                               int N, int K, int is_int8, void* stream) {
  const dim3 grid(N / kBN, M / kBM);
  if (is_int8) {
    dot_kernel<int><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)a, (const unsigned char*)b, N, K, (int*)c);
  } else {
    dot_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)a, (const unsigned char*)b, N, 2 * K, (float*)c);
  }
  return (int)cudaGetLastError();
}
