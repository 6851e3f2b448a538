// Exact masked k-nearest-neighbour selection, one launch a batch.
//
// Replaces no TPU kernel: the JAX package selects with XLA's top-k
// (cmdiad_tpu/ops/knn.py masked_knn: lax.top_k, approx_max_k on a TPU).
// The port's plain version (ops/knn.py _knn_plain) writes a (G, P) float32
// distance matrix a part, widens it to int64 (distance bits, index) keys
// and runs torch.topk over them: some 3-5 GB of device traffic a part for
// G x P pairs of a few operations each.
//
// Semantics, _knn_plain's bit for bit (finite inputs): the squared
// distance (|c|^2 + |p|^2) - 2 c.p in float32, clamped at +0.0, with the
// norms handed in by the wrapper (torch's own sums, as pairwise_sqdist
// takes them) and the cross term rounded as cuBLAS's float32 GEMM rounds a
// depth-3 product, an FMA chain in x, y, z order; a masked point at the
// distance ``big`` (BIG_DIST); each center's k smallest (distance bits,
// index) keys ascending, so ties go to the lower index (lax.top_k's
// order); a selected masked point replaced by the part's first valid one.
//
// What bounds it on the card: operations.  B x G x P pairs of about 7
// float32 operations (0.34 GOP a part at G 1024, P 32768: about 5 us at
// 67 TFLOP/s); the bytes are the points (0.5 MB a part packed, from L2
// once a block) and k int64 indices a center out.
//
// Design: a block of 8 warps takes 8 centers of one part, one a warp.
//   * The wrapper packs each point as (x, y, z, |p|^2), -1 in the last
//     slot for a masked point.  The part's points stream through shared
//     memory in tiles of 512, double buffered: cp.async copies the next
//     tile while the warps scan the current one, so a point is read from
//     L2 once a block and by each warp from shared memory.
//   * Each warp keeps its center's candidates in a shared-memory buffer of
//     CAP 64-bit keys (512 for k <= 128, 1024 up to 256) and a threshold,
//     the k-th smallest key at its last reduction (all ones before the
//     first).  A point whose key is not below the threshold is rejected by
//     one 64-bit compare; the others are appended in lane order (ballot
//     and popc).  Before each group of 4 steps (128 points) the warp makes
//     room if it has to: it sorts its buffer (bitonic, in shared memory),
//     keeps the k smallest and takes the k-th as its threshold.  After a
//     tile it also reduces as soon as it holds k keys, so the threshold is
//     finite from the first tile on.
//   * Tiles are visited in a golden-ratio order (tile t m mod n, m coprime
//     with n and near 0.618 n), so that the first tiles spread over the
//     part and the threshold tightens fast: a compacted cloud in scan order
//     approaches a center row by row, and a sequential scan appends most
//     of the rows before it.
//   * A tile holding no valid point is skipped once its least key, the
//     masked key (big, first index), is not below the threshold:
//     compacted parts are a valid prefix of 12k-26k of 32768 slots, so
//     about 40 % of the scan drops; a dense cloud skips nothing.
//   * At the end the warp sorts once more and writes its k smallest,
//     masked points replaced by the first valid one.
// The library builds with --fmad=false; the GEMM's contractions are
// written as fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <numeric>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;                 // centers a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerThread = 2;             // points a thread copies a tile
constexpr int kTile = kThreads * kPerThread;
constexpr int kGroup = 4;                 // steps of 32 points between room checks
constexpr int kMaxK = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kNone = ~0ull;         // above every point's key

// pairwise_sqdist's value on the card: (c2 + p2) - 2 ab, ab the FMA chain
// cuBLAS forms at depth 3 (2 ab is exact, so one fmaf rounds the
// difference once), clamped at +0.0 (-0.0 included).
__device__ __forceinline__ float sqdist(float cx, float cy, float cz,
                                        float c2, float4 p) {
  const float ab = fmaf(cz, p.z, fmaf(cy, p.y, __fmul_rn(cx, p.x)));
  const float d = fmaf(-2.0f, ab, __fadd_rn(c2, p.w));
  return d > 0.0f ? d : 0.0f;
}

// Sort the warp's N keys ascending (bitonic, in shared memory).
template <int N>
__device__ __forceinline__ void sort_keys(uint64_t* buf, int lane) {
#pragma unroll 1
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int t = lane; t < N / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1));  // pair (i, i + stride)
        const uint64_t a = buf[i], b = buf[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[i + stride] = a;
        }
      }
      __syncwarp();
    }
  }
}

// The warp's count of its keys (R a lane) that ``below`` says lie below.
template <int R, typename F>
__device__ __forceinline__ int count_keys(const uint64_t (&key)[R], F below) {
  int c = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) c += below(key[r]) ? 1 : 0;
  return (int)__reduce_add_sync(kFull, (unsigned)c);
}

// Keep the k smallest of the warp's n keys (k <= n <= CAP) in buf[0, k),
// in no order, and return the k-th smallest.  The keys move to registers,
// CAP / 32 a lane; a binary search over the high word (distance bits, at
// most 0x7f800000 after the clamp) finds the k-th's, and where keys of
// that distance lie on both sides of the k-th, one over the low word
// (index) settles it.
template <int CAP>
__device__ __forceinline__ uint64_t keep_smallest(uint64_t* buf, int& n, int k,
                                                  int lane) {
  constexpr int R = CAP / 32;
  uint64_t key[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    key[r] = i < n ? buf[i] : kNone;
  }
  __syncwarp();
  uint32_t lo = 0, hi = 0x7f800000u;  // the k-th's high word lies in [lo, hi]
  while (lo < hi) {
    const uint32_t mid = lo + ((hi - lo) >> 1);
    if (count_keys<R>(key, [&](uint64_t x) { return (uint32_t)(x >> 32) <= mid; }) >= k)
      hi = mid;
    else
      lo = mid + 1;
  }
  const uint32_t h = lo;
  const int below = count_keys<R>(key, [&](uint64_t x) { return (uint32_t)(x >> 32) < h; });
  const int at = count_keys<R>(key, [&](uint64_t x) { return (uint32_t)(x >> 32) == h; });
  uint32_t l0 = 0, l1 = 0xffffffffu;  // the k-th's low word
  if (below + at == k) {  // no tie across the k-th: the largest index at h
    uint32_t top = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((uint32_t)(key[r] >> 32) == h) top = max(top, (uint32_t)key[r]);
    l0 = l1 = __reduce_max_sync(kFull, top);
  }
  while (l0 < l1) {
    const uint32_t mid = l0 + ((l1 - l0) >> 1);
    const uint64_t top = ((uint64_t)h << 32) | mid;
    if (below + count_keys<R>(key, [&](uint64_t x) { return x >> 32 == h && x <= top; }) >= k)
      l1 = mid;
    else
      l0 = mid + 1;
  }
  const uint64_t kth = ((uint64_t)h << 32) | l0;
  n = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool keep = key[r] <= kth;
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (keep) buf[n + __popc(ballot & ((1u << lane) - 1u))] = key[r];
    n += __popc(ballot);
  }
  __syncwarp();
  return kth;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float4* __restrict__ pts, const float* __restrict__ centers,
           const float* __restrict__ c2,
           const long long* __restrict__ first_valid, int P, int G, int k,
           int m, float big, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tiles = reinterpret_cast<float4*>(smem);  // [2][kTile]
  uint64_t* buf =
      reinterpret_cast<uint64_t*>(tiles + 2 * kTile) + (threadIdx.x >> 5) * CAP;

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = g < G;
  const float4* part = pts + (size_t)b * P;
  const uint32_t big_bits = __float_as_uint(big);
  float cx = 0.0f, cy = 0.0f, cz = 0.0f, cc = 0.0f;
  if (active) {
    const float* c = centers + ((size_t)b * G + g) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
    cc = c2[(size_t)b * G + g];
  }

  // Start the copies of the tile at ``base`` into ``slot``.
  auto fetch = [&](int base, int slot) {
    float4* dst = tiles + slot * kTile;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int j = threadIdx.x + q * kThreads;
      if (base + j < P)
        cp_async16(dst + j, part + base + j);
      else
        dst[j] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Wait for this thread's copies into ``slot``; whether the tile holds a
  // valid point, across the block (a barrier).
  auto landed = [&](int slot) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    bool any = false;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q)
      any |= tiles[slot * kTile + threadIdx.x + q * kThreads].w >= 0.0f;
    return __syncthreads_or(any) != 0;
  };

  const int nt = (P + kTile - 1) / kTile;
  int n = 0;
  uint64_t thr = kNone;
  int ti = 0;  // the tile visited t-th: t m mod nt
  fetch(0, 0);
  bool any = landed(0);
  for (int t = 0; t < nt; ++t) {
    const int base = ti * kTile;
    ti += m;
    if (ti >= nt) ti -= nt;
    if (t + 1 < nt) fetch(ti * kTile, (t + 1) & 1);  // lands during the scan
    const bool skip = !any && thr <= (((uint64_t)big_bits << 32) | (uint32_t)base);
    if (active && !skip) {
      const float4* tile = tiles + (t & 1) * kTile;
#pragma unroll 1
      for (int s0 = 0; s0 < kTile / 32; s0 += kGroup) {
        if (n > CAP - 32 * kGroup) thr = keep_smallest<CAP>(buf, n, k, lane);
        float4 p[kGroup];
#pragma unroll
        for (int s = 0; s < kGroup; ++s) p[s] = tile[(s0 + s) * 32 + lane];
#pragma unroll
        for (int s = 0; s < kGroup; ++s) {
          const uint32_t i = base + (s0 + s) * 32 + lane;
          const uint32_t hi = p[s].w < 0.0f
                                  ? big_bits
                                  : __float_as_uint(sqdist(cx, cy, cz, cc, p[s]));
          const uint64_t key = (int)i < P ? ((uint64_t)hi << 32) | i : kNone;
          const bool pass = key < thr;
          const unsigned ballot = __ballot_sync(kFull, pass);
          if (pass) buf[n + __popc(ballot & ((1u << lane) - 1u))] = key;
          n += __popc(ballot);
        }
      }
      if (thr == kNone && n >= k) thr = keep_smallest<CAP>(buf, n, k, lane);
    }
    if (t + 1 < nt) any = landed((t + 1) & 1);
  }
  if (!active) return;
  // every point was appended until the first reduction, so n >= k (k <= P);
  // then the k kept, ascending
  keep_smallest<CAP>(buf, n, k, lane);
  for (int i = k + lane; i < CAP / 4; i += 32) buf[i] = kNone;
  __syncwarp();
  sort_keys<CAP / 4>(buf, lane);
  long long* o = out + ((size_t)b * G + g) * k;
  const long long first = first_valid[b];
  for (int j = lane; j < k; j += 32) {
    const uint32_t idx = (uint32_t)buf[j];
    o[j] = part[idx].w >= 0.0f ? (long long)idx : first;
  }
}

template <int CAP>
int launch(dim3 grid, cudaStream_t st, const float4* pts, const float* centers,
           const float* c2, const long long* first_valid, int P, int G, int k,
           int m, float big, long long* out) {
  constexpr int smem = 2 * kTile * sizeof(float4) + kWarps * CAP * sizeof(uint64_t);
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  knn_kernel<CAP><<<grid, kThreads, smem, st>>>(pts, centers, c2, first_valid,
                                                P, G, k, m, big, out);
  return (int)cudaGetLastError();
}

// The tile stride of the visiting order over nt tiles: the integer nearest
// 0.618 nt, raised until it is coprime with nt.
int golden_stride(int nt) {
  int m = std::max(1, (int)std::lround(nt * 0.6180339887498949));
  while (std::gcd(m, nt) != 1) ++m;
  return m;
}

}  // namespace

// pts: (B, P) float4 points (x, y, z, |p|^2), -1 in the last slot for a
// masked point, 16-byte aligned; centers: (B, G, 3) float32; c2: (B, G)
// their squared norms; first_valid: (B,) int64; big: a masked point's
// distance; out: (B, G, k) int64.  1 <= k <= min(256, P) and B <= 65535
// (otherwise cudaErrorInvalidValue).  Returns cudaGetLastError() after the
// launch.
extern "C" int knn_launch(const void* pts, const void* centers, const void* c2,
                          const void* first_valid, int B, int P, int G, int k,
                          float big, void* out, void* stream) {
  if (B < 1 || B > 65535 || P < 1 || G < 1 || k < 1 || k > kMaxK || k > P)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((G + kWarps - 1) / kWarps, B);
  const int m = golden_stride((P + kTile - 1) / kTile);
  const auto st = (cudaStream_t)stream;
  const auto* x = (const float4*)pts;
  const auto* c = (const float*)centers;
  const auto* cn = (const float*)c2;
  const auto* fv = (const long long*)first_valid;
  auto* o = (long long*)out;
  if (k <= 128) return launch<512>(grid, st, x, c, cn, fv, P, G, k, m, big, o);
  return launch<1024>(grid, st, x, c, cn, fv, P, G, k, m, big, o);
}
