// Fused 3-nearest-neighbour inverse-distance interpolation of center
// features onto every grid point.
//
// Replaces the TPU kernel cmdiad_tpu/ops/pallas_interp.py:_kernel (reached
// through three_nn_interpolate_pallas).  Semantics: squared distance by the
// dot-product identity, (|c|^2 + |p|^2) - 2 c.p, clamped at 0 (coincident
// pairs cancel to about -1e-7, and every FPS center is an input point);
// the 3 nearest centers by (distance, index), so ties go to the first
// occurrence; weights 1/(d + 1e-8) normalised to sum 1; the output row is
// the weighted sum of the 3 centers' feature rows; masked points give 0.
//
// What bounds it on the card: writing the output, P * D values per set
// (50176 x 768 float32 = 154 MB per image, 46 us at 3.35 TB/s; half that in
// bfloat16).  The distance search is about 0.5 GFLOP per image on the CUDA
// cores and the center features (3 MB per image) stay in L2.  Measured at
// B 8, the search alone and the bfloat16 write alone take about the same
// time, so the two have to overlap.
//
// Design: a block takes one tile of 128 consecutive points, one a thread,
// eight blocks a SM (64 registers a thread), so that while one block
// searches others write.
//   * The centers sit in shared memory as one float4 each, (x, y, z, |c|^2):
//     one broadcast load per center in the search.
//   * The tile is compacted first (ballot and a prefix over the warps): its
//     valid points in order, then its masked ones.  The first warps search
//     the valid points, one a lane, and meanwhile the other warps write the
//     masked points' zero rows, so that part of the output stream overlaps
//     the search inside the block.  A search thread scans all G centers
//     keeping a sorted top 3 with a strict '<', which orders by (distance,
//     index) exactly like three rounds of first-occurrence argmin, then
//     leaves the three indices and weights in shared memory.
//   * Then every warp writes valid rows: warp w takes an equal share of the
//     valid points in their order and walks them one column chunk at a
//     time (4 float32 or 8 bfloat16 values a lane: 16-byte loads and
//     streaming 16-byte stores).  It keeps the three feature pieces of the
//     last centers it used in registers, tagged with their center, and
//     loads only those of a new point's centers that it does not hold:
//     neighbouring grid points of an organized scan mostly share their
//     centers, so much of the L2 gather falls away.  In bfloat16 the
//     launcher first rounds the feature rows to bfloat16 once (a small
//     kernel of its own), so each gather moves half the bytes.
// All distance and weight arithmetic is rounded one operation at a time in
// the plain version's order (the library builds with --fmad=false; the one
// fmaf is (|p|^2 + |c|^2) - 2 dot, 2 dot being exact), so the selections,
// weights and sums equal the plain version's bit for bit.  With BF16 the
// weights and feature values are rounded to bfloat16 before the float32
// products and the result is stored as bfloat16, as the TPU kernel's bf16
// mode does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;            // points per block, one per thread
constexpr int kWarps = kTile / 32;
// as many blocks a SM as 64 registers a thread allow
constexpr int kBlocksPerSM = 65536 / (kTile * 64);
constexpr unsigned kFull = 0xffffffffu;

// One lane's 16 bytes of an output row and the feature values behind them.
template <bool BF16>
struct Piece;

template <>
struct Piece<false> {
  using Elem = float;
  static constexpr int kVals = 4;
  float4 f;
  __device__ __forceinline__ void load(const float* p) {
    f = __ldg(reinterpret_cast<const float4*>(p));
  }
  // (w0 a + w1 b) + w2 c per value, stored without keeping it in cache
  __device__ __forceinline__ static void store(void* dst, const float4& w,
                                               const Piece& a, const Piece& b,
                                               const Piece& c) {
    float4 o;
    o.x = __fadd_rn(__fadd_rn(__fmul_rn(w.x, a.f.x), __fmul_rn(w.y, b.f.x)),
                    __fmul_rn(w.z, c.f.x));
    o.y = __fadd_rn(__fadd_rn(__fmul_rn(w.x, a.f.y), __fmul_rn(w.y, b.f.y)),
                    __fmul_rn(w.z, c.f.y));
    o.z = __fadd_rn(__fadd_rn(__fmul_rn(w.x, a.f.z), __fmul_rn(w.y, b.f.z)),
                    __fmul_rn(w.z, c.f.z));
    o.w = __fadd_rn(__fadd_rn(__fmul_rn(w.x, a.f.w), __fmul_rn(w.y, b.f.w)),
                    __fmul_rn(w.z, c.f.w));
    __stcs(reinterpret_cast<float4*>(dst), o);
  }
  __device__ __forceinline__ static void zero(void* dst) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(0.f, 0.f, 0.f, 0.f));
  }
};

// bfloat16: 8 feature values, already rounded to bfloat16 (the launcher's
// first kernel rounds the feature rows once, so a gather moves 2 bytes a
// value instead of 4)
template <>
struct Piece<true> {
  using Elem = __nv_bfloat16;
  static constexpr int kVals = 8;
  __nv_bfloat162 h[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    h[0] = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    h[1] = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    h[2] = *reinterpret_cast<const __nv_bfloat162*>(&v.z);
    h[3] = *reinterpret_cast<const __nv_bfloat162*>(&v.w);
  }
  __device__ __forceinline__ static void store(void* dst, const float4& w,
                                               const Piece& a, const Piece& b,
                                               const Piece& c) {
    uint4 o;
    uint32_t* ou = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 fa = __bfloat1622float2(a.h[k]);
      const float2 fb = __bfloat1622float2(b.h[k]);
      const float2 fc = __bfloat1622float2(c.h[k]);
      const float vx = __fadd_rn(
          __fadd_rn(__fmul_rn(w.x, fa.x), __fmul_rn(w.y, fb.x)),
          __fmul_rn(w.z, fc.x));
      const float vy = __fadd_rn(
          __fadd_rn(__fmul_rn(w.x, fa.y), __fmul_rn(w.y, fb.y)),
          __fmul_rn(w.z, fc.y));
      const __nv_bfloat162 r = __floats2bfloat162_rn(vx, vy);
      ou[k] = *reinterpret_cast<const uint32_t*>(&r);
    }
    __stcs(reinterpret_cast<uint4*>(dst), o);
  }
  __device__ __forceinline__ static void zero(void* dst) {
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(0u, 0u, 0u, 0u));
  }
};

// n float32 values (n % 4 == 0) rounded to bfloat16
__global__ void round_bf16_kernel(const float4* __restrict__ in,
                                  uint2* __restrict__ out, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = __ldg(in + i);
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    out[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                        *reinterpret_cast<const uint32_t*>(&b));
  }
}

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// The 3 nearest centers of one point by (distance, index), a strict '<'
// over the centers in order, and their weights, into s_idx / s_w.
template <bool BF16>
__device__ __forceinline__ void search_point(const float* __restrict__ pp,
                                             const float4* cs, int G,
                                             int4* s_idx, float4* s_w) {
  const float px = pp[0], py = pp[1], pz = pp[2];
  const float pn = sqnorm3(px, py, pz);
  float d0 = 3.4e38f, d1 = 3.4e38f, d2 = 3.4e38f;
  int i0 = 0, i1 = 0, i2 = 0;
#pragma unroll 4
  for (int j = 0; j < G; ++j) {
    const float4 c = cs[j];
    const float dot = __fadd_rn(
        __fadd_rn(__fmul_rn(px, c.x), __fmul_rn(py, c.y)), __fmul_rn(pz, c.z));
    const float d = fmaxf(fmaf(-2.0f, dot, __fadd_rn(pn, c.w)), 0.0f);
    if (d < d2) {
      if (d < d1) {
        d2 = d1; i2 = i1;
        if (d < d0) { d1 = d0; i1 = i0; d0 = d; i0 = j; }
        else { d1 = d; i1 = j; }
      } else {
        d2 = d; i2 = j;
      }
    }
  }
  const float r0 = __fdiv_rn(1.0f, __fadd_rn(d0, 1e-8f));
  const float r1 = __fdiv_rn(1.0f, __fadd_rn(d1, 1e-8f));
  const float r2 = __fdiv_rn(1.0f, __fadd_rn(d2, 1e-8f));
  const float s = __fadd_rn(__fadd_rn(r0, r1), r2);
  float4 w = make_float4(__fdiv_rn(r0, s), __fdiv_rn(r1, s), __fdiv_rn(r2, s),
                         0.0f);
  if (BF16) {
    w.x = __bfloat162float(__float2bfloat16_rn(w.x));
    w.y = __bfloat162float(__float2bfloat16_rn(w.y));
    w.z = __bfloat162float(__float2bfloat16_rn(w.z));
  }
  *s_idx = make_int4(i0, i1, i2, 0);
  *s_w = w;
}

template <bool BF16>
__global__ void __launch_bounds__(kTile, kBlocksPerSM)
three_nn_interp_kernel(const float* __restrict__ pts,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ centers,
                       const typename Piece<BF16>::Elem* __restrict__ feats,
                       int P, int G, int D, void* __restrict__ out,
                       int phases) {
  using Pc = Piece<BF16>;
  constexpr int kVals = Pc::kVals;
  constexpr int kOutBytes = BF16 ? 2 : 4;
  extern __shared__ float4 cs[];        // G centers: x, y, z, |c|^2
  __shared__ int4 s_idx[kTile];         // the k-th valid point's 3 centers
  __shared__ float4 s_w[kTile];         // and their weights
  __shared__ short s_list[kTile];       // valid points first, then masked
  __shared__ int s_count[kWarps];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int n = min(kTile, P - p0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  char* ob = static_cast<char*>(out) + (size_t)b * P * D * kOutBytes;

  const float* cb = centers + (size_t)b * G * 3;
  for (int j = tid; j < G; j += kTile) {
    const float x = cb[j * 3 + 0], y = cb[j * 3 + 1], z = cb[j * 3 + 2];
    cs[j] = make_float4(x, y, z, sqnorm3(x, y, z));
  }

  // compact the tile: the valid points to s_list[0, nvalid) in order, the
  // masked ones (those in range) to s_list[nvalid, n)
  const int p = p0 + tid;
  const bool valid = (phases & 1) && p < P && mask[(size_t)b * P + p] != 0;
  const unsigned ballot = __ballot_sync(kFull, valid);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, nvalid = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_count[w] : 0;
    nvalid += s_count[w];
  }
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (valid) s_list[before + rank] = tid;
  else if (p < P) s_list[nvalid + (warp * 32 - before) + (lane - rank)] = tid;
  __syncthreads();

  // the first ceil(nvalid / 32) warps search, one valid point a lane; the
  // others write the masked points' zero rows meanwhile (all warps do,
  // after the search, when every warp searched)
  const int nsearch = (nvalid + 31) / 32;
  auto write_zeros = [&](int first_warp) {
    if (!(phases & 2)) return;
    const int nw = kWarps - first_warp;
    for (int k = nvalid + (warp - first_warp); k < n; k += nw) {
      char* row = ob + ((size_t)(p0 + s_list[k]) * D) * kOutBytes;
      for (int c = lane * kVals; c < D; c += 32 * kVals)
        Pc::zero(row + (size_t)c * kOutBytes);
    }
  };
  if (tid < nvalid) {
    const int q = s_list[tid];
    search_point<BF16>(pts + ((size_t)b * P + p0 + q) * 3, cs, G, s_idx + tid,
                       s_w + tid);
  } else if (warp >= nsearch) {
    write_zeros(nsearch);
  }
  __syncthreads();
  if (!(phases & 2)) return;
  if (nsearch == kWarps) write_zeros(0);

  // the valid rows: warp w takes the valid points [k0, k1) of the compacted
  // order (consecutive grid points), a column chunk at a time; tag[a] names
  // the center whose piece f[a] holds (-1: none).  Tags are the same on
  // every lane, so the branches are uniform.
  const int per = (nvalid + kWarps - 1) / kWarps;
  const int k0 = warp * per, k1 = min(k0 + per, nvalid);
  const typename Pc::Elem* fb = feats + (size_t)b * G * D;
  for (int cbase = 0; cbase < D; cbase += 32 * kVals) {
    const int c = cbase + lane * kVals;
    const bool on = c < D;
    Pc f[3];
    int tag[3] = {-1, -1, -1};
    for (int k = k0; k < k1; ++k) {
      const int4 id = s_idx[k];
      char* dst = ob + ((size_t)(p0 + s_list[k]) * D + c) * kOutBytes;
      const int want[3] = {id.x, id.y, id.z};
      Pc nw[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (want[a] == tag[0]) nw[a] = f[0];
        else if (want[a] == tag[1]) nw[a] = f[1];
        else if (want[a] == tag[2]) nw[a] = f[2];
        else if (on) nw[a].load(fb + (size_t)want[a] * D + c);
      }
      if (on) Pc::store(dst, s_w[k], nw[0], nw[1], nw[2]);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        f[a] = nw[a];
        tag[a] = want[a];
      }
    }
  }
}

template <bool BF16>
int launch(const void* pts, const void* mask, const void* centers,
           const void* feats, int B, int P, int G, int D, void* out,
           int phases, cudaStream_t stream) {
  const int smem = G * (int)sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      three_nn_interp_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kTile - 1) / kTile, B);
  three_nn_interp_kernel<BF16><<<grid, kTile, smem, stream>>>(
      (const float*)pts, (const uint8_t*)mask, (const float*)centers,
      (const typename Piece<BF16>::Elem*)feats, P, G, D, out, phases);
  return (int)cudaGetLastError();
}

}  // namespace

// pts: (B, P, 3) float32; mask: (B, P) bytes, nonzero = valid; centers:
// (B, G, 3) float32 with G >= 3; feats: (B, G, D) float32; out: (B, P, D)
// float32, or bfloat16 when bf16 != 0, in which case feats_bf16 is a
// (B, G, D) bfloat16 scratch that receives the rounded features first.
// phases: 3 runs the kernel; 1 only its search (nothing is written), 2
// only its writer with no search (every point written as masked), to time
// the two apart.  Requires D % 8 == 0 and 16-byte aligned feats,
// feats_bf16 and out.  Returns cudaGetLastError().
extern "C" int three_nn_interp_launch(const void* pts, const void* mask,
                                      const void* centers, const void* feats,
                                      void* feats_bf16, int B, int P, int G,
                                      int D, int bf16, void* out, int phases,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16)
    return launch<false>(pts, mask, centers, feats, B, P, G, D, out, phases, st);
  const size_t n4 = (size_t)B * G * D / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024);
  round_bf16_kernel<<<blocks, 256, 0, st>>>((const float4*)feats,
                                            (uint2*)feats_bf16, n4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch<true>(pts, mask, centers, feats_bf16, B, P, G, D, out, phases,
                      st);
}
