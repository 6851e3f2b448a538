// The 'jax' OCSVM fitter's SGD steps on the card, in float32.
//
// Replaces no TPU kernel: it is the counterpart of the JAX package's
// jax.lax.scan over the rows of every epoch (cmdiad_tpu/fusion/ocsvm.py:78
// _fit_jax), which XLA compiles into a sequential loop.  Each step is JAX's,
// every operation rounded to float32 in JAX's order:
//   eta    = 1 / (alpha * (t0 + t))
//   margin = rho - w . x          (the dot as w0*x0 + w1*x1 + ...)
//   active = margin > 0 ? 1 : 0
//   w      = w - eta * (alpha * w - active * x)
//   rho    = rho - eta * (active - nu)
//   t      = t + 1                (float32: it stops at 2^24)
// Built with --fmad=false: an FMA would round once where JAX rounds twice.
//
// The wrapper (cmdiad_tpu_torch/fusion/ocsvm.py) gathers the rows of a block
// of epochs into their visiting order and launches one block of threads;
// the state (w padded to kMaxD, rho, t) lives in a small device buffer
// between launches.  Thread 0 carries the state through every step.  The
// other warps fill the next shared-memory tile (its rows and its step sizes:
// t only counts, so t and eta of every step are known ahead) while thread 0
// works through the current one.
//
// What bounds it: the steps depend on each other through w and rho, so the
// time is the number of steps times the latency of one step's chain (dot,
// margin, select, gradient, update: some eight dependent float32
// operations), not the card's rate.  The roofline bound (rows read once, a
// few tens of operations a step) is some four orders below it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxD = 4;        // the fusers give 1 or 2 columns
constexpr int kTile = 1024;     // steps a shared-memory tile
constexpr int kThreads = 128;   // warp 0: the state; warps 1-3: the tiles
constexpr long long kStall = 1LL << 24;   // float32 t + 1 == t from here

template <int D>
struct Tile {
  float x[kTile * D];
  float eta[kTile];
};

// Warps 1-3 copy the rows of steps [first, first + count) and compute their
// step sizes: step k of the launch has t = min(t_start + k, 2^24), an
// integer below 2^24 and so exact in float32, as JAX's sequence t + 1 is.
template <int D>
__device__ __forceinline__ void fill(Tile<D>& tile, const float* __restrict__ rows,
                                     long long first, int count, float alpha,
                                     float t0, long long t_start) {
  const int lane = threadIdx.x - 32;
  const int stride = kThreads - 32;
  const float* src = rows + first * D;
  for (int k = lane; k < count * D; k += stride) tile.x[k] = src[k];
  for (int k = lane; k < count; k += stride) {
    long long tk = t_start + first + k;
    const float t = (float)(tk < kStall ? tk : kStall);
    tile.eta[k] = 1.0f / (alpha * (t0 + t));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ocsvm_sgd_kernel(const float* __restrict__ rows, long long steps, float alpha,
                 float t0, float nu, float* __restrict__ state) {
  __shared__ Tile<D> tiles[2];
  const long long t_start = (long long)state[kMaxD + 1];
  const int n_tiles = (int)((steps + kTile - 1) / kTile);
  float w[D];
  float rho = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) w[j] = state[j];
    rho = state[kMaxD];
  }
  // active - nu for the two values of active, rounded as JAX rounds it
  const float pull_on = 1.0f - nu, pull_off = 0.0f - nu;
  if (threadIdx.x >= 32)
    fill(tiles[0], rows, 0, (int)(steps < kTile ? steps : kTile), alpha, t0, t_start);
  __syncthreads();
  for (int k = 0; k < n_tiles; ++k) {
    const long long first = (long long)k * kTile;
    if (threadIdx.x == 0) {
      const Tile<D>& cur = tiles[k & 1];
      const int count = (int)(steps - first < kTile ? steps - first : kTile);
#pragma unroll 4
      for (int s = 0; s < count; ++s) {
        const float* x = cur.x + s * D;
        const float eta = cur.eta[s];
        float dot = w[0] * x[0];
#pragma unroll
        for (int j = 1; j < D; ++j) dot = dot + w[j] * x[j];
        const bool active = rho - dot > 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          // active * x: x itself, or 0 * x (a zero of x's sign)
          const float ax = active ? x[j] : 0.0f * x[j];
          w[j] = w[j] - eta * (alpha * w[j] - ax);
        }
        rho = rho - eta * (active ? pull_on : pull_off);
      }
    } else if (threadIdx.x >= 32 && k + 1 < n_tiles) {
      const long long next = first + kTile;
      fill(tiles[(k + 1) & 1], rows, next,
           (int)(steps - next < kTile ? steps - next : kTile), alpha, t0, t_start);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) state[j] = w[j];
    state[kMaxD] = rho;
    const long long t_end = t_start + steps;
    state[kMaxD + 1] = (float)(t_end < kStall ? t_end : kStall);
  }
}

}  // namespace

// rows: (steps, d) float32 in visiting order; state: float32[kMaxD + 2] =
// w (zero-padded), rho, t (an integer-valued float32), read and written.
extern "C" int ocsvm_sgd_launch(const float* rows, long long steps, int d,
                                float alpha, float t0, float nu, float* state,
                                cudaStream_t stream) {
  if (steps <= 0) return 0;
  switch (d) {
    case 1: ocsvm_sgd_kernel<1><<<1, kThreads, 0, stream>>>(rows, steps, alpha, t0, nu, state); break;
    case 2: ocsvm_sgd_kernel<2><<<1, kThreads, 0, stream>>>(rows, steps, alpha, t0, nu, state); break;
    case 3: ocsvm_sgd_kernel<3><<<1, kThreads, 0, stream>>>(rows, steps, alpha, t0, nu, state); break;
    case 4: ocsvm_sgd_kernel<4><<<1, kThreads, 0, stream>>>(rows, steps, alpha, t0, nu, state); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
