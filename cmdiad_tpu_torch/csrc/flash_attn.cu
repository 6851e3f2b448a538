// Fused multi-head self-attention, softmax(q.k^T).v per (batch, head).
//
// Replaces the TPU kernel cmdiad_tpu/ops/flash_attn.py:_attn_kernel
// (reached through fused_attention with use_flash=True).  Semantics, as
// there: q arrives pre-scaled in the compute dtype; scores are products of
// compute-dtype operands summed in float32 and stay float32; keys past the
// sequence end get -inf; the softmax runs in float32 and the normalised p
// is rounded to the compute dtype before p.v; p.v accumulates in float32
// and the output is rounded to the compute dtype.  The TPU's paddings
// (head dim 64 -> 128 lanes, 785 -> 1024 keys) were layout and are not
// carried over: the ragged last key tile is masked in place.
//
// What bounds it on the card: at the backbones' shapes (B 8, 12 heads x
// 785 tokens, or 6 heads x 1024 tokens, head dim 64) the two n x n x 64
// products q.k^T and p.v are 15.1 and 12.9 GFLOP in bfloat16 (15.3 and
// 13.0 us at 989 TFLOP/s), above the bytes moved; in float32 about 226 and
// 192 us at 67 TFLOP/s.  The two passes below compute q.k^T twice.
//
// Design, two passes over the keys so that p is rounded where the TPU
// kernel rounds it: pass 1 keeps a running row max and sum; pass 2
// recomputes the scores, forms the normalised p, rounds it and accumulates
// p.v.  K and V stream through shared memory in tiles of 64 keys.
//   bfloat16: one block of 4 warps per (batch.head, 64 queries); each warp
//     owns 16 queries, keeps its q fragments in registers and runs
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) for q.k^T and for p.v,
//     the score accumulators feeding the p.v fragments directly.
//   float32: plain FFMA (no TF32), one thread per query holding its q row
//     and output row in registers, 128 queries per block, K/V rows read
//     from shared memory as broadcasts.
// q, k, v are read in place from the (B, N, 3, H, 64) qkv projection
// through a batch and a token stride; the output is (B, N, H, 64).  Not yet
// done: ldmatrix, cp.async double buffering, wgmma, a one-pass variant.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;
constexpr int kBQ = 64;         // bf16: queries per block (16 per warp)
constexpr int kStride = kD + 8; // bf16: elements per staged row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Stage rows [k0, k0 + kBK) of one head of k (and v) into shared memory,
// zeros past the sequence end.
__device__ __forceinline__ void stage_bf16(
    const __nv_bfloat16* __restrict__ src, size_t base, long long sn, int k0,
    int N, __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < kBK * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + base + (size_t)(k0 + r) * sn + c);
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

// One warp's 16 x 64 score tile against the staged keys; keys >= N -> -inf.
__device__ __forceinline__ void score_tile(const uint32_t (&aq)[4][4],
                                           const __nv_bfloat16* Ks, int k0,
                                           int N, int g, int t4,
                                           float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* bp = Ks + (nt * 8 + g) * kStride + ks * 16 + t4 * 2;
      uint32_t b[2];
      b[0] = ld32(bp);
      b[1] = ld32(bp + 8);
      mma_16816(s[nt], aq[ks], b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + nt * 8 + t4 * 2 + (e & 1) >= N) s[nt][e] = -INFINITY;
}

__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int N, int H,
                  long long sb, long long sn, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ * kStride];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * kStride];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)b * sb + (size_t)h * kD;

  // q pre-scaled in bfloat16: the float product of two bfloat16 values is
  // exact, so rounding it once gives the bfloat16 product
  for (int i = tid; i < kBQ * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < N) {
      val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * sn + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * kStride + c) = val;
  }
  __syncthreads();
  uint32_t aq[4][4];
  const __nv_bfloat16* qa = Qs + (warp * 16) * kStride;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const __nv_bfloat16* ap = qa + ks * 16 + t4 * 2;
    aq[ks][0] = ld32(ap + g * kStride);
    aq[ks][1] = ld32(ap + (g + 8) * kStride);
    aq[ks][2] = ld32(ap + g * kStride + 8);
    aq[ks][3] = ld32(ap + (g + 8) * kStride + 8);
  }

  // pass 1: running max and sum per query row (rows g and g + 8); the four
  // threads of a row share its max, so their partial sums combine at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float s[8][4];
  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();
    stage_bf16(k, base, sn, k0, N, Ks);
    __syncthreads();
    score_tile(aq, Ks, k0, N, g, t4, s);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mn = fmaxf(m[hh], mx);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        sum += expf(s[nt][2 * hh] - mn) + expf(s[nt][2 * hh + 1] - mn);
      l[hh] = l[hh] * expf(m[hh] - mn) + sum;
      m[hh] = mn;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
  }

  // pass 2: p = exp(s - m) / l rounded to bfloat16, o += p.v in float32
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();
    stage_bf16(k, base, sn, k0, N, Ks);
    stage_bf16(v, base, sn, k0, N, Vs);
    __syncthreads();
    score_tile(aq, Ks, k0, N, g, t4, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {       // 16 keys: score tiles 2kk, 2kk+1
      uint32_t ap[4];
      const float* s0 = s[2 * kk];
      const float* s1 = s[2 * kk + 1];
      ap[0] = pack2f(__fdiv_rn(expf(s0[0] - m[0]), l[0]),
                     __fdiv_rn(expf(s0[1] - m[0]), l[0]));
      ap[1] = pack2f(__fdiv_rn(expf(s0[2] - m[1]), l[1]),
                     __fdiv_rn(expf(s0[3] - m[1]), l[1]));
      ap[2] = pack2f(__fdiv_rn(expf(s1[0] - m[0]), l[0]),
                     __fdiv_rn(expf(s1[1] - m[0]), l[0]));
      ap[3] = pack2f(__fdiv_rn(expf(s1[2] - m[1]), l[1]),
                     __fdiv_rn(expf(s1[3] - m[1]), l[1]));
      const __nv_bfloat16* vr = Vs + (kk * 16 + t4 * 2) * kStride + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* vp = vr + nt * 8;
        uint32_t bf[2];
        bf[0] = pack2(vp[0], vp[kStride]);
        bf[1] = pack2(vp[8 * kStride], vp[9 * kStride]);
        mma_16816(o[nt], ap, bf);
      }
    }
  }

  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = row + hh * 8;
    if (n >= N) continue;
    __nv_bfloat16* dst = out + ((size_t)b * N + n) * H * kD + (size_t)h * kD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8 + t4 * 2) =
          pack2f(o[nt][2 * hh], o[nt][2 * hh + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int N,
                 int H, long long sb, long long sn, float scale) {
  __shared__ __align__(16) float Ks[kBK * kD];
  __shared__ __align__(16) float Vs[kBK * kD];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const size_t base = (size_t)b * sb + (size_t)h * kD;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N) x = *reinterpret_cast<const float4*>(q + base + (size_t)n * sn + d);
    qr[d] = __fmul_rn(x.x, scale);
    qr[d + 1] = __fmul_rn(x.y, scale);
    qr[d + 2] = __fmul_rn(x.z, scale);
    qr[d + 3] = __fmul_rn(x.w, scale);
  }

  auto stage = [&](const float* __restrict__ src, float* dst, int k0) {
    for (int i = threadIdx.x; i < kBK * (kD / 4); i += kThreads) {
      const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < N)
        x = *reinterpret_cast<const float4*>(src + base + (size_t)(k0 + r) * sn + c);
      *reinterpret_cast<float4*>(dst + r * kD + c) = x;
    }
  };
  auto dot = [&](const float* kr) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(kr + d);
      acc = fmaf(qr[d], x.x, acc);
      acc = fmaf(qr[d + 1], x.y, acc);
      acc = fmaf(qr[d + 2], x.z, acc);
      acc = fmaf(qr[d + 3], x.w, acc);
    }
    return acc;
  };

  // pass 1: running max and sum
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();
    stage(k, Ks, k0);
    __syncthreads();
    const int nk = min(kBK, N - k0);
    for (int j = 0; j < nk; ++j) {
      const float sc = dot(Ks + j * kD);
      if (sc > m) {
        l = l * expf(m - sc) + 1.0f;
        m = sc;
      } else {
        l += expf(sc - m);
      }
    }
  }

  // pass 2: p = exp(s - m) / l, o += p.v
  float o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();
    stage(k, Ks, k0);
    stage(v, Vs, k0);
    __syncthreads();
    const int nk = min(kBK, N - k0);
    for (int j = 0; j < nk; ++j) {
      const float p = __fdiv_rn(expf(dot(Ks + j * kD) - m), l);
      const float* vr = Vs + j * kD;
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(vr + d);
        o[d] = fmaf(p, x.x, o[d]);
        o[d + 1] = fmaf(p, x.y, o[d + 1]);
        o[d + 2] = fmaf(p, x.z, o[d + 2]);
        o[d + 3] = fmaf(p, x.w, o[d + 3]);
      }
    }
  }
  if (n < N) {
    float* dst = out + ((size_t)b * N + n) * H * kD + (size_t)h * kD;
#pragma unroll
    for (int d = 0; d < kD; d += 4)
      *reinterpret_cast<float4*>(dst + d) =
          make_float4(o[d], o[d + 1], o[d + 2], o[d + 3]);
  }
}

}  // namespace

// q, k, v: one head's rows at q + b * sb + n * sn + h * 64 (elements), the
// 64 values of a row contiguous, bfloat16 (is_bf16 = 1) or float32; out:
// (B, N, H, 64) contiguous, same type; scale already rounded to that type.
// Requires 16-byte aligned pointers and strides that are multiples of 8
// elements.  Returns cudaGetLastError().
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int N, int H, long long sb,
                                 long long sn, float scale, int is_bf16,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const dim3 grid((N + kBQ - 1) / kBQ, B * H);
    flash_bf16_kernel<<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, N, H, sb, sn, scale);
  } else {
    const dim3 grid((N + kThreads - 1) / kThreads, B * H);
    flash_f32_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, N, H,
        sb, sn, scale);
  }
  return (int)cudaGetLastError();
}
