// Grid-hashed DBSCAN on the card.
//
// Replaces no TPU kernel: it is the counterpart of the JAX package's host
// C++ routine (cmdiad_tpu/native/cmdiad_native.cc:268 dbscan), which the
// MVTec 3D-AD preprocessing runs over every valid point of a scan.  Labels
// are those of cmdiad_tpu_torch/preprocess/cluster.py: a point is core
// when at least min_points points (itself included) lie within eps, tested
// as ((dx*dx + dy*dy) + dz*dz) <= eps*eps in float64 from the float32
// coordinates (built with --fmad=false, so no FMA fuses the sum); core
// points within eps form components; a non-core point takes the smallest
// root among its core neighbours.
//
// The wrapper sorts the points by grid cell (cells a little wider than
// eps), so a point's eps-neighbours lie in its 27 neighbour cells, and
// passes, per cell, its range of sorted points and its 27 neighbour cells.
// One thread a sorted point; the threads of a warp mostly share a cell, so
// they walk the same candidate lists and their loads broadcast.  Four
// kernels on the stream:
//   count_neighbours  eps-neighbours of each point (core flags), and
//                     parent[i] = i;
//   unite_cores       union-find over core-core pairs (each pair once, from
//                     its later sorted point): the larger root is hooked
//                     under the smaller with atomicCAS, so every root is its
//                     component's smallest original index; a pair already
//                     under one root is skipped;
//   flatten_cores     every core point's parent set to its root;
//   label_points      a core point's root, or the smallest root among a
//                     non-core point's core eps-neighbours, or -1.
// No pair list is stored: at MVTec density a point has thousands of
// eps-neighbours.  The wrapper ranks the roots into cluster ids.
//
// What bounds it: the pair tests, some 8 float64 operations each, done
// once per kernel that walks the candidates (three times) over about 2.9
// candidates per eps-pair on a surface (27 cells against an eps-disc);
// bytes are a few per point.  The float64 test is the price of labels
// equal to the C++ routine's: float32 would flip boundary pairs.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Grid {
  const float* x;
  const float* y;
  const float* z;
  const int* orig;        // original index of each sorted point
  const int* cell_of;     // cell of each sorted point
  const int* cell_start;  // sorted points of cell c: [cell_start[c], cell_start[c + 1])
  const int* neigh;       // (cells, 27) neighbour cells, -1 where empty
  int n;
  double eps2;
};

__device__ __forceinline__ bool within(const Grid& g, float px, float py,
                                       float pz, int t) {
  double dx = (double)px - (double)g.x[t];
  double dy = (double)py - (double)g.y[t];
  double dz = (double)pz - (double)g.z[t];
  double s = dx * dx + dy * dy;
  s = s + dz * dz;
  return s <= g.eps2;
}

// Calls f(t) for every sorted point t within eps of sorted point s.
template <typename F>
__device__ __forceinline__ void for_each_neighbour(const Grid& g, int s, F f) {
  const float px = g.x[s], py = g.y[s], pz = g.z[s];
  const int* nb = g.neigh + (int64_t)g.cell_of[s] * 27;
  for (int k = 0; k < 27; ++k) {
    const int c = nb[k];
    if (c < 0) continue;
    const int end = g.cell_start[c + 1];
    for (int t = g.cell_start[c]; t < end; ++t)
      if (within(g, px, py, pz, t)) f(t);
  }
}

__device__ __forceinline__ int load(const int* p) {
  return *(const volatile int*)p;
}

// Root of i with path halving.  Parents only ever point to smaller
// indices (min-hooking), so every value written is an ancestor.
__device__ int representative(int* parent, int i) {
  int curr = load(parent + i);
  if (curr != i) {
    int next, prev = i;
    while (curr > (next = load(parent + curr))) {
      parent[prev] = next;
      prev = curr;
      curr = next;
    }
  }
  return curr;
}

// Union of the sets of roots ru and rv: hook the larger root under the
// smaller; a failed CAS means the root moved, so continue from its parent.
__device__ void unite(int* parent, int ru, int rv) {
  while (ru != rv) {
    if (ru < rv) {
      const int old = atomicCAS(parent + rv, rv, ru);
      if (old == rv) return;
      rv = old;
    } else {
      const int old = atomicCAS(parent + ru, ru, rv);
      if (old == ru) return;
      ru = old;
    }
  }
}

__global__ void count_neighbours(Grid g, int* count, int* parent) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < g.n;
       s += gridDim.x * blockDim.x) {
    int cnt = 0;
    for_each_neighbour(g, s, [&](int) { ++cnt; });
    count[s] = cnt;
    parent[g.orig[s]] = g.orig[s];
  }
}

__global__ void unite_cores(Grid g, int min_points, const int* count, int* parent) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < g.n;
       s += gridDim.x * blockDim.x) {
    if (count[s] < min_points) continue;
    const int me = g.orig[s];
    int mine = representative(parent, me);
    for_each_neighbour(g, s, [&](int t) {
      if (t >= s || count[t] < min_points) return;
      const int theirs = representative(parent, g.orig[t]);
      if (theirs == mine) return;
      unite(parent, mine, theirs);
      mine = representative(parent, me);
    });
  }
}

__global__ void flatten_cores(Grid g, int min_points, const int* count, int* parent) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < g.n;
       s += gridDim.x * blockDim.x) {
    if (count[s] < min_points) continue;
    const int me = g.orig[s];
    parent[me] = representative(parent, me);
  }
}

__global__ void label_points(Grid g, int min_points, const int* count,
                             const int* parent, int* root) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < g.n;
       s += gridDim.x * blockDim.x) {
    const int me = g.orig[s];
    if (count[s] >= min_points) {
      root[me] = parent[me];
      continue;
    }
    int best = INT_MAX;
    for_each_neighbour(g, s, [&](int t) {
      if (count[t] >= min_points) best = min(best, parent[g.orig[t]]);
    });
    root[me] = best == INT_MAX ? -1 : best;
  }
}

}  // namespace

// xyz: (3, n) float32 coordinates of the points sorted by cell; orig,
// cell_of: (n,) int32; cell_start: (cells + 1,) int32; neigh: (cells, 27)
// int32.  count (sorted order), parent and root (original order): (n,)
// int32 scratch and outputs.  Returns cudaGetLastError() after the first
// failing launch, or 0.
extern "C" int dbscan_launch(const float* xyz, const int* orig, const int* cell_of,
                             const int* cell_start, const int* neigh, int n,
                             double eps2, int min_points, int* count, int* parent,
                             int* root, cudaStream_t stream) {
  if (n <= 0) return 0;
  Grid g{xyz, xyz + n, xyz + 2 * (int64_t)n, orig, cell_of, cell_start, neigh, n, eps2};
  const int blocks = (n + kThreads - 1) / kThreads;
  count_neighbours<<<blocks, kThreads, 0, stream>>>(g, count, parent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unite_cores<<<blocks, kThreads, 0, stream>>>(g, min_points, count, parent);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flatten_cores<<<blocks, kThreads, 0, stream>>>(g, min_points, count, parent);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  label_points<<<blocks, kThreads, 0, stream>>>(g, min_points, count, parent, root);
  return (int)cudaGetLastError();
}
