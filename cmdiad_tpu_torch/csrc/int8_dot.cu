// Whole-array product on the tensor cores, int8 or bfloat16: a probe.
//
// Replaces the TPU probe kernel benchmarks/probe_int8_dot.py:_kern, which
// asked whether the TPU compiles s8 x s8 -> s32 products and how fast they
// run against bf16 x bf16 -> f32 at the bank kernel's tile shape.  Here it
// asks the same of wgmma on the card: C = A . B^T with A (M, K) and B (N, K),
// both K-contiguous (the bank-min kernels' layout), C (M, N) int32 or
// float32.
//
// What bounds it on the card: 2 M N K operations against the bytes moved,
// the 4-byte output above all.  At 8192 x 768 x 8192 the output is 268 MB,
// 0.080 ms at 3.35 TB/s: the int8 product (0.052 ms at 1979 TOP/s) is
// bound by that write, the bf16 one (0.104 ms at 989 TFLOP/s) by its
// operations, with the write needing nearly all of that time beside it.
//
// Design (the bf16 bank-min's skeleton, csrc/bank_min.cu):
//   * Output tiles of 64 kCW x 256, kCW consumer warpgroups of 64 rows
//     each: two, or one when tiles of 128 rows would leave SMs idle (1024 x
//     2048 gives 64 such tiles for 132 SMs, 128 of 64 rows).  K arrives in
//     stages of 128 bytes (64 bfloat16 or 128 int8 columns: one 128-byte
//     swizzle row), so both types use the same TMA boxes, shared-memory
//     layout and descriptor step; a wgmma k-step consumes 32 bytes in both.
//     Only the instruction differs: m64n256k16 f32.bf16.bf16 or m64n256k32
//     s32.s8.s8 (integer wgmma takes both operands K-major, which is this
//     layout).
//   * A 4-stage TMA ring that one producer thread keeps full; setmaxnreg
//     moves registers from the producer warpgroup to the consumers' 128
//     accumulators; persistent CTAs, one per SM, over a tile order grouped
//     by 16 row tiles.
//   * Epilogue: each warp writes its 16 x 256 part of the accumulator in
//     eight 16 x 32 boxes (128-byte rows, 128-byte swizzle: the fragment
//     layout's 8-byte pairs land in distinct banks) through two 2 KB
//     buffers of its own, and its lane 0 sends each box out with a TMA
//     store, so a warp waits only for its own stores (__syncwarp, no
//     warpgroup barrier).  The stores are asynchronous: the last ones of a
//     tile drain while the next tile's main loop runs, and a buffer is
//     waited for (its store has read it) only when it is written again.
//     Boxes wholly past the edge are not written at all.
// Rows or columns of a tile past M or N read as zeros (TMA's out-of-bounds
// fill) and are not written (TMA stores stop at the tensor's edge).

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBN = 256;      // rows of B per tile
constexpr int kKB = 128;      // bytes of K per stage
constexpr int kStages = 4;
constexpr int kGroupM = 16;   // row tiles per group of the tile order
constexpr int kStageB = kBN * kKB;  // bytes per stage
constexpr int kBoxCols = 32;  // 4-byte outputs per store box row
constexpr int kBox = 16 * kBoxCols * 4;  // bytes per (16-row) store box

// A CTA of kCW consumer warpgroups and a producer warpgroup.
template <int kCW>
struct Shape {
  static constexpr int kBM = 64 * kCW;  // rows of A per tile
  static constexpr int kThreads = 128 * (kCW + 1);
  static constexpr int kStageA = kBM * kKB;
  static constexpr int kSmem = 1024 + kStages * (kStageA + kStageB) +
                               4 * kCW * 2 * kBox + 2 * kStages * 8;
};

__device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db,
                                    int scale_d) {
  wgmma_m64n256k32(d, da, db, scale_d);
}
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db,
                                    int scale_d) {
  wgmma_m64n256k16(d, da, db, scale_d);
}

// Keep the compiler from touching an accumulator before the wait that
// completes its wgmma.
__device__ __forceinline__ void keep(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ void store2(unsigned char* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}
__device__ __forceinline__ void store2(unsigned char* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Acc: int (s8 operands) or float (bf16 operands).  nk: stages of K.
template <typename Acc, int kCW>
__global__ void __launch_bounds__(Shape<kCW>::kThreads, 1)
dot_kernel(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb,
           const __grid_constant__ CUtensorMap tc, int M, int N, int nk,
           int cols_per_stage) {
  constexpr int kBM = Shape<kCW>::kBM, kStageA = Shape<kCW>::kStageA;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sB = sA + kStages * kStageA;
  unsigned char* sC = sB + kStages * kStageB;  // [warp][buffer] boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + 4 * kCW * 2 * kBox);
  uint64_t* empty = full + kStages;

  const int nmb = (M + kBM - 1) / kBM, nnb = (N + kBN - 1) / kBN;
  const int ntiles = nmb * nnb;
  const int group = kGroupM * nnb;
  auto tile_coords = [&](int t, int& mb, int& nb) {
    const int first = (t / group) * kGroupM;
    const int gm = min(nmb - first, kGroupM);
    const int r = t % group;
    mb = first + r % gm;
    nb = r / gm;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCW);
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
        int mb, nb;
        tile_coords(t, mb, nb);
        for (int k = 0; k < nk; ++k) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], kStageA + kStageB);
          tma_load_2d(sA + s * kStageA, &ta, &full[s], k * cols_per_stage,
                      mb * kBM);
          tma_load_2d(sB + s * kStageB, &tb, &full[s], k * cols_per_stage,
                      nb * kBN);
          if (++s == kStages) { s = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;  // 64-row part of the tile
    const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    unsigned char* box = sC + (4 * cw + warp) * 2 * kBox;  // this warp's
    Acc acc[128];
    int s = 0, phase = 0, nsent = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int mb, nb;
      tile_coords(t, mb, nb);
      int prev = -1;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&full[s], phase);
        const uint64_t da = desc_sw128(sA + s * kStageA + cw * 64 * kKB);
        const uint64_t db = desc_sw128(sB + s * kStageB);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKB / 32; ++kk)
          mma(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
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
      for (int i = 0; i < 128; ++i) keep(acc[i]);

      // epilogue: box c holds the warp's 16 rows of accumulator columns
      // 32c .. 32c + 31, i.e. acc[4 j + 2 h + e] for j = 4c .. 4c + 3 (row
      // g + 8h of the box); a box row is 128 bytes whose 16-byte chunks
      // are swizzled by the row & 7 (= g).  The buffers alternate by the
      // count of boxes sent (nsent), so the store that wait_read<1> leaves
      // in flight is always the other buffer's.
      const int row0 = mb * kBM + cw * 64 + 16 * warp;
#pragma unroll
      for (int c = 0; c < kBN / kBoxCols; ++c) {
        const int col0 = nb * kBN + c * kBoxCols;
        if (col0 >= N || row0 >= M) continue;  // wholly past the edge
        unsigned char* buf = box + (nsent & 1) * kBox;
        if (lane == 0) tma_store_wait_read<1>();  // this buffer's last store
        __syncwarp();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 4 * c + jj;
            const int chunk = (2 * jj + (t4 >> 1)) ^ g;
            store2(buf + (g + 8 * h) * 128 + chunk * 16 + (t4 & 1) * 8,
                   acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        fence_async_shared();
        __syncwarp();
        if (lane == 0) {
          tma_store_2d(&tc, buf, col0, row0);
          tma_store_commit();
        }
        ++nsent;
      }
    }
    if (lane == 0) tma_store_wait_all();
  }
}

// The probe's small shapes take a few microseconds, so the launcher's host
// work counts: the shared-memory attribute is set once per kernel and
// device.
template <typename Acc, int kCW>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const CUtensorMap& tc, int M, int N, int nk,
                   int cols_per_stage, int grid, cudaStream_t st) {
  using S = Shape<kCW>;
  static int set_for = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (set_for != dev) {
    const cudaError_t err = cudaFuncSetAttribute(
        dot_kernel<Acc, kCW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmem);
    if (err != cudaSuccess) return err;
    set_for = dev;
  }
  dot_kernel<Acc, kCW><<<grid, S::kThreads, S::kSmem, st>>>(
      ta, tb, tc, M, N, nk, cols_per_stage);
  return cudaGetLastError();
}

template <typename Acc>
cudaError_t launch_for(const void* a, const void* b, void* c, int M, int N,
                       int K, cudaStream_t st) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  constexpr bool is_int8 = std::is_same<Acc, int>::value;
  const CUtensorMapDataType in_type = is_int8
                                          ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int elem = is_int8 ? 1 : 2;
  const int cols = kKB / elem;  // K columns per stage
  // two consumer warpgroups unless 128-row tiles leave SMs idle
  const int nnb = (N + kBN - 1) / kBN;
  const int cw = ((M + 127) / 128) * nnb < sms ? 1 : 2;
  const int ntiles = ((M + 64 * cw - 1) / (64 * cw)) * nnb;
  CUtensorMap ta, tb, tc;
  if (!matrix_map_sw128(&ta, in_type, elem, a, M, K, 64 * cw, cols) ||
      !matrix_map_sw128(&tb, in_type, elem, b, N, K, kBN, cols) ||
      !matrix_map_sw128(&tc, is_int8 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, c, M, N, 16, kBoxCols))
    return cudaErrorNotSupported;
  const int nk = K * elem / kKB;
  const int grid = ntiles < sms ? ntiles : sms;
  return cw == 1 ? launch<Acc, 1>(ta, tb, tc, M, N, nk, cols, grid, st)
                 : launch<Acc, 2>(ta, tb, tc, M, N, nk, cols, grid, st);
}

}  // namespace

// a: (M, K), b: (N, K), both int8 (is_int8 = 1, c int32) or bfloat16
// (is_int8 = 0, c float32); c: (M, N) = a . b^T.  Requires M % 64 == 0,
// N % 64 == 0, K a multiple of 128 bytes (128 int8 or 64 bfloat16) and
// 16-byte aligned pointers.  Returns cudaGetLastError(), or
// cudaErrorNotSupported when the driver gives no tensor-map encoder.
extern "C" int int8_dot_launch(const void* a, const void* b, void* c, int M,
                               int N, int K, int is_int8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_int8 ? launch_for<int>(a, b, c, M, N, K, st)
                       : launch_for<float>(a, b, c, M, N, K, st));
}
