// Masked farthest point sampling, one thread-block cluster per point set.
//
// Replaces the TPU kernel cmdiad_tpu/ops/fps.py:_fps_pallas_kernel (reached
// through _fps_batched_pallas and farthest_point_sample).  Semantics: the
// running min squared distance starts at 1e10 for valid points and -1 for
// invalid ones (so they are never picked while a valid one remains); the
// seed is the first valid point (0 if none); each step picks the largest
// running distance, the lowest index among equal maxima.
//
// What bounds it on the card: not bytes or operations (about 0.3 GFLOP and
// 0.4 MB per set at P = 32768, G = 1024) but the chain of G dependent
// steps: the latency of one step, a pass over the set and an argmax over
// it, is what the design shrinks.
//
// Design: a cluster of C CTAs (8, or 16 when all B clusters of 16 fit on
// the card at once) per set, each CTA of 512 threads owning a contiguous
// slice of C-th of the points (padded to C x 512 x K), K points a thread
// at indices slice + thread + 512 k.
//   * The state lives in registers: each thread loads its points' x, y, z
//     and running distance once, coalesced, and keeps them for all G steps.
//     No step reads device memory.
//   * A candidate is a 64-bit key: the order-preserving bits of its
//     running distance (-0.0 made +0.0) in the high word, ~index in the
//     low word, compared as signed; the largest key is the largest
//     distance at the lowest index.  A slot holding no point (past P, or a
//     thread with none) has the least key (high word kAbsentHi = INT_MIN,
//     low word 0), below that of any value, -1 included
//     (ops/fps.py:pack_argmax_keys).
//   * One step: each thread updates its distances with the last center and
//     scans them in increasing index order with a strict '>'; a warp
//     reduces the keys (two redux.sync maxima: high word, then low word
//     among the lanes that hold it), its winner lane puts {key, x, y, z} in
//     shared memory; __syncthreads; warp 0 reduces the warp winners and its
//     lane r sends the CTA's winner (20 bytes, two st.async) into slot
//     [s & 1][rank] of cluster rank r, completing the bytes on that CTA's
//     transaction barrier bar[s & 1].  Each CTA arms its barrier for C
//     candidates, so it completes once all have landed: one cluster-wide
//     barrier a step, at which no thread has to arrive for another (a
//     barrier.cluster arrive/wait in its place would make every thread of
//     the cluster join it).
//     Then every warp reduces the C slots itself, lane r reading rank r's,
//     so the next center's index and coordinates are known everywhere with
//     no global load and no second barrier.
//   * Why one barrier a step is enough: exchange s writes buffer s & 1 and
//     a CTA reads it once its bar[s & 1] completes.  Rank Y writes rank X's
//     buffer s & 1 again only in exchange s + 2, after Y's barrier of
//     exchange s + 1 completed, which needs X's candidate of exchange
//     s + 1, which X sends only after all its threads passed __syncthreads
//     of that exchange, so after they read exchange s.  So no slot is
//     overwritten while it may still be read, and exchange s + 2's bytes
//     reach bar[s & 1] only after its phase of exchange s completed (the
//     phase parity of exchange s is (s >> 1) & 1).  Candidates may land
//     before a CTA arms its barrier: the transaction count is negative
//     meanwhile, and the phase cannot complete before the arming arrival.
//     Likewise a warp's slot in the CTA's per-warp table is rewritten only
//     after the barrier of exchange s completed, which needs warp 0's send,
//     made after it read the table.
//   * Clusters of 16 are taken only when all B fit on the card at once
//     with one CTA an SM (each CTA reserves more than half an SM's shared
//     memory, which it does not use): two CTAs of a cluster sharing an SM
//     take turns at every step.  A caller may ask for either size
//     (chip_smoke.py times both at B 1, 3 and 8).
//   * The seed (first valid index) is exchange 0, with the key of a
//     thread's first valid point at distance 0.  Rank 0 writes out[b, g].
// The distance is ((dx*dx + dy*dy) + dz*dz) with round-to-nearest
// intrinsics and no FMA (the build passes --fmad=false), the plain
// version's order, so the picked indices match it exactly.

#include <cooperative_groups.h>
#include <limits.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAbsentHi = INT_MIN;  // high word of the least key

// A candidate: key words {hi, lo} and coordinates, 20 bytes in 32.
struct __align__(16) Slot {
  int4 w;  // hi (ordered distance), lo (~index), x bits, y bits
  float z;
};

__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v + 0.0f);  // -0.0 -> +0.0
  return b < 0 ? b ^ 0x7fffffff : b;
}

constexpr int kSlotBytes = 20;  // what a candidate's two st.async carry

// The address of ``p``'s counterpart in the shared memory of cluster rank r.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(r));
  return out;
}


// The cluster-wide largest key among the threads' candidates, and its
// point's index and coordinates, written to every thread's (idx, x, y, z).
// ``slots`` is this CTA's [2][C] exchange table, ``bar`` its two
// transaction barriers, ``wslot`` its per-warp table; s numbers the
// exchange (0 for the seed).
template <int C>
__device__ __forceinline__ void exchange(int hi, unsigned lo, float x, float y,
                                         float z, int s, Slot* wslot,
                                         Slot (*slots)[C], uint64_t* bar,
                                         int& idx, float& lx, float& ly,
                                         float& lz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Slot* table = slots[s & 1];
  {
    const int mh = __reduce_max_sync(kFull, hi);
    const unsigned ml = __reduce_max_sync(kFull, hi == mh ? lo : 0u);
    const unsigned who = __ballot_sync(kFull, hi == mh && lo == ml);
    if (lane == __ffs(who) - 1) {
      wslot[warp].w = make_int4(hi, (int)lo, __float_as_int(x),
                                __float_as_int(y));
      wslot[warp].z = z;
    }
  }
  // this exchange's barrier completes once the C candidates have landed
  if (threadIdx.x == 0) mbar_expect_tx(&bar[s & 1], C * kSlotBytes);
  __syncthreads();
  if (warp == 0) {
    Slot c;
    c.w = make_int4(kAbsentHi, 0, 0, 0);
    c.z = 0.0f;
    if (lane < kWarps) c = wslot[lane];
    const int h = c.w.x;
    const unsigned l = (unsigned)c.w.y;
    const int mh = __reduce_max_sync(kFull, h);
    const unsigned ml = __reduce_max_sync(kFull, h == mh ? l : 0u);
    const int src = __ffs(__ballot_sync(kFull, h == mh && l == ml)) - 1;
    const int wx = __shfl_sync(kFull, c.w.z, src);
    const int wy = __shfl_sync(kFull, c.w.w, src);
    const int wz = __shfl_sync(kFull, __float_as_int(c.z), src);
    if (lane < C) {  // lane r sends the CTA's winner to rank r
      const uint32_t rank = cg::this_cluster().block_rank();
      const uint32_t dst = map_rank(&table[rank], lane);
      const uint32_t rbar = map_rank(&bar[s & 1], lane);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
          " [%0], {%1, %2, %3, %4}, [%5];\n"
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
          " [%6], %7, [%5];\n"
          :: "r"(dst), "r"(mh), "r"(ml), "r"(wx), "r"(wy), "r"(rbar),
             "r"(dst + 16), "r"(wz)
          : "memory");
    }
  }
  // exchange s is the (s >> 1)-th use of its barrier
  const uint32_t b = smem_u32(&bar[s & 1]);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"((s >> 1) & 1) : "memory");
  }
  // every warp reduces the C slots itself, lane r reading rank r's
  int4 w = make_int4(kAbsentHi, 0, 0, 0);
  float rz = 0.0f;
  if (lane < C) {
    w = table[lane].w;
    rz = table[lane].z;
  }
  const int mh = __reduce_max_sync(kFull, w.x);
  const unsigned ml = __reduce_max_sync(kFull, w.x == mh ? (unsigned)w.y : 0u);
  const int src = __ffs(__ballot_sync(kFull, w.x == mh && (unsigned)w.y == ml)) - 1;
  idx = mh == kAbsentHi ? 0 : (int)~ml;
  lx = __int_as_float(__shfl_sync(kFull, w.z, src));
  ly = __int_as_float(__shfl_sync(kFull, w.w, src));
  lz = __shfl_sync(kFull, rz, src);
}

template <int C, int K>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
           int P, int G, int* __restrict__ out) {
  __shared__ Slot wslot[kWarps];
  __shared__ Slot slots[2][C];
  __shared__ uint64_t bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const float* xs = xyz + (size_t)b * 3 * P;
  const float* ys = xs + P;
  const float* zs = ys + P;
  const uint8_t* m = mask + (size_t)b * P;
  int* o = out + (size_t)b * G;
  const int first = rank * kThreads * K + threadIdx.x;  // index of k = 0

  float x[K], y[K], z[K], d[K];
  int sk = -1;  // this thread's first valid point
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = first + kThreads * k;
    if (i < P) {
      x[k] = xs[i];
      y[k] = ys[i];
      z[k] = zs[i];
      const bool valid = m[i] != 0;
      d[k] = valid ? 1e10f : -1.0f;
      if (valid && sk < 0) sk = k;
    } else {  // padding: never updated, never a candidate
      x[k] = y[k] = z[k] = 0.0f;
      d[k] = -INFINITY;
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  // every CTA of the cluster is running, its barriers ready, before any
  // writes to another
  cluster.sync();

  // the coordinates of point k of this thread (k known only at run time)
  auto coords = [&](int kk, float& cx, float& cy, float& cz) {
    cx = cy = cz = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (kk == k) { cx = x[k]; cy = y[k]; cz = z[k]; }
  };

  int last;
  float lx, ly, lz;
  {
    float cx, cy, cz;
    coords(sk, cx, cy, cz);
    exchange<C>(sk < 0 ? kAbsentHi : ordered(0.0f),
                sk < 0 ? 0u : ~(unsigned)(first + kThreads * sk), cx, cy, cz,
                0, wslot, slots, bar, last, lx, ly, lz);
  }

  for (int g = 0; g < G; ++g) {
    if (rank == 0 && threadIdx.x == 0) o[g] = last;
    if (g + 1 == G) break;
    float bv = -INFINITY;
    int bk = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dx = __fsub_rn(x[k], lx);
      const float dy = __fsub_rn(y[k], ly);
      const float dz = __fsub_rn(z[k], lz);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      d[k] = d[k] >= 0.0f ? fminf(d[k], dd) : d[k];
      if (d[k] > bv) { bv = d[k]; bk = k; }
    }
    float cx, cy, cz;
    coords(bk, cx, cy, cz);
    exchange<C>(bk < 0 ? kAbsentHi : ordered(bv),
                bk < 0 ? 0u : ~(unsigned)(first + kThreads * bk), cx, cy, cz,
                g + 1, wslot, slots, bar, last, lx, ly, lz);
  }
  // no CTA leaves while another may still write into its shared memory
  cluster.sync();
}

// Dynamic shared memory a CTA reserves and never uses: more than half of
// an SM's, so that each CTA has an SM to itself (two CTAs of one cluster on
// one SM would take turns at every step).
int reserved_smem() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                           dev);
    bytes = per_sm / 2 + 1024;
  }
  return bytes;
}

// B clusters of C CTAs on stream st; attr is the attribute array it names.
cudaLaunchConfig_t config(int C, int B, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = reserved_smem();
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel for C CTAs of K points a thread, its attributes set.
template <int C, int K>
const void* prepared() {
  static bool done = false;
  const void* kern = (const void*)fps_kernel<C, K>;
  if (!done) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         reserved_smem());
    if (C > 8)
      cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1);
    done = true;
  }
  return kern;
}

// Points a thread holds for P points over C CTAs: the least of 2, 4, 8,
// 16 that covers them, 0 if none does.
int points_per_thread(int C, int P) {
  for (int k = 2; k <= 16; k *= 2)
    if ((long long)C * kThreads * k >= P) return k;
  return 0;
}

template <int C>
const void* kernel_for(int P) {
  switch (points_per_thread(C, P)) {
    case 2: return prepared<C, 2>();
    case 4: return prepared<C, 4>();
    case 8: return prepared<C, 8>();
    case 16: return prepared<C, 16>();
    default: return nullptr;
  }
}

// Whether all B clusters of 16 CTAs fit on the card at once, one CTA an SM.
bool sixteen_fit(int B, int P) {
  const void* kern = kernel_for<16>(P);
  if (!kern) return false;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(16, B, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear the query's error
    return false;
  }
  return n >= B;
}

}  // namespace

// CTAs per set that fps_launch uses for B sets of P points: 16 when all B
// clusters of 16 fit on the card at once, one CTA an SM, else 8.  The answer for the last
// (B, P) asked is kept.
extern "C" int fps_cluster_size(int B, int P) {
  static int last_b = -1, last_p = -1, last_c = 8;
  if (B != last_b || P != last_p) {
    last_c = sixteen_fit(B, P) ? 16 : 8;
    last_b = B;
    last_p = P;
  }
  return last_c;
}

// xyz: (B, 3, P) float32 coordinates, structure of arrays; mask: (B, P)
// bytes, nonzero = valid; out: (B, G) int32; clusters: CTAs per set, 8 or
// 16, or 0 for fps_cluster_size's choice.  P <= 8 x 512 x 16 = 65536 (more,
// or another cluster size, returns cudaErrorInvalidValue).  Returns the
// launch's error, or cudaGetLastError() after it.
extern "C" int fps_launch(const void* xyz, const void* mask, int B, int P,
                          int G, int clusters, void* out, void* stream) {
  const int C = clusters ? clusters : fps_cluster_size(B, P);
  if (C != 8 && C != 16) return (int)cudaErrorInvalidValue;
  const void* kern = C == 16 ? kernel_for<16>(P) : kernel_for<8>(P);
  if (!kern) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(C, B, (cudaStream_t)stream, attr);
  const float* x = (const float*)xyz;
  const uint8_t* m = (const uint8_t*)mask;
  int* o = (int*)out;
  void* args[] = {&x, &m, &P, &G, &o};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kern, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
