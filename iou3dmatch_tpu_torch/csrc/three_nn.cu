// Three nearest neighbours: for each query point of a scene, the indices of
// the 3 nearest of the scene's seed points and the distances to them.
//
// Replaces the XLA program iou3dmatch_tpu/ops/interpolate.py::three_nn
// (exact=True, interpolate.py:20-68: three fused argmin passes over an
// elementwise d2), itself the counterpart of the reference ThreeNN
// (interpolate_gpu.cu:14-74). The port calls it from GridConv (16,384 grid
// points a scene against 1,024 seeds in training, 8,192 in serving) and
// from FP1 and FP2 (512 x 256 and 1,024 x 512).
//
// What bounds it on the H100: operations. Each (query, seed) pair costs 3
// subtractions, 3 products, 2 sums and a compare, none fused (the file is
// built with -fmad=false, see ops/_build.py); the bytes (the queries, the
// seeds and the outputs, each once) are a few MB. So the seeds never leave
// the chip, and nothing but the outputs goes to HBM:
//
// - one thread a query, kThreads queries of one scene a block, a grid of
//   B x ceil(n / kThreads) blocks;
// - the block stages its scene's seeds in shared memory as x[], y[], z[]
//   (structure of arrays), kTile seeds at a time, so any m works; at
//   m <= 1,024 one tile holds them all;
// - every lane of a warp reads the same seed at the same time, a broadcast
//   with no bank conflicts, four seeds a float4 load of each array, and
//   one compare and branch tests whether any of the four enters the top 3
//   (a branch a seed cost 25 % more at GridConv's shape, PERF.md);
// - each thread keeps its top 3 as (d2, index) in registers and scans the
//   seeds in index order.
//
// Exactness against the plain version (ops/interpolate.py::three_nn_plain)
// and JAX: d2 is (dx dx + dy dy) + dz dz with dx = u.x - k.x, each
// difference, product and sum rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn). The order is ascending d2, and a candidate scanned later takes
// a slot only when it goes strictly before the slot's entry, so the lower
// index wins ties; a NaN d2 goes before any number, the lower index first,
// as argmin takes it. The slots start at (+inf, 0), which gives the plain
// version's answers where fewer than 3 seeds have a finite d2 (m < 3, or
// distances that overflow): its argmin passes then pick index 0, the first
// of an all-inf row. dist is __fsqrt_rn of the selected seeds' d2 computed
// again, as the plain version computes it.
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // seeds staged a time: 12 KB

__device__ __forceinline__ float sq_dist(float ux, float uy, float uz, float kx, float ky, float kz) {
  const float dx = __fsub_rn(ux, kx), dy = __fsub_rn(uy, ky), dz = __fsub_rn(uz, kz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// a candidate goes before a held d2: NaN before any number, else smaller
__device__ __forceinline__ bool before(float c, float s) { return isnan(c) ? !isnan(s) : c < s; }

__device__ __forceinline__ void insert(float d, int j, float (&dd)[3], int (&ii)[3]) {
  if (d >= dd[2] || !before(d, dd[2])) return;  // the common case: one compare
  if (before(d, dd[1])) {
    dd[2] = dd[1];
    ii[2] = ii[1];
    if (before(d, dd[0])) {
      dd[1] = dd[0];
      ii[1] = ii[0];
      dd[0] = d;
      ii[0] = j;
    } else {
      dd[1] = d;
      ii[1] = j;
    }
  } else {
    dd[2] = d;
    ii[2] = j;
  }
}

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                float* __restrict__ dist, int* __restrict__ idx, int n, int m,
                int blocks_per_scene) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sy[kTile];
  __shared__ __align__(16) float sz[kTile];
  const int scene = blockIdx.x / blocks_per_scene;
  const int q = (blockIdx.x - scene * blocks_per_scene) * kThreads + threadIdx.x;
  const bool active = q < n;
  const long long row = static_cast<long long>(scene) * n + (active ? q : 0);
  const float ux = unknown[row * 3], uy = unknown[row * 3 + 1], uz = unknown[row * 3 + 2];
  const float* seeds = known + static_cast<long long>(scene) * m * 3;

  float dd[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  int ii[3] = {0, 0, 0};
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* p = seeds + static_cast<long long>(t0 + j) * 3;
      sx[j] = p[0];
      sy[j] = p[1];
      sz[j] = p[2];
    }
    __syncthreads();
    if (!active) continue;
    int j = 0;
    for (; j + 4 <= cnt; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sx + j);
      const float4 y = *reinterpret_cast<const float4*>(sy + j);
      const float4 z = *reinterpret_cast<const float4*>(sz + j);
      const float d0 = sq_dist(ux, uy, uz, x.x, y.x, z.x);
      const float d1 = sq_dist(ux, uy, uz, x.y, y.y, z.y);
      const float d2 = sq_dist(ux, uy, uz, x.z, y.z, z.z);
      const float d3 = sq_dist(ux, uy, uz, x.w, y.w, z.w);
      // one branch for the four in the common case, where none goes before
      // the third slot (a NaN fails every >=)
      if (d0 >= dd[2] && d1 >= dd[2] && d2 >= dd[2] && d3 >= dd[2]) continue;
      insert(d0, t0 + j, dd, ii);
      insert(d1, t0 + j + 1, dd, ii);
      insert(d2, t0 + j + 2, dd, ii);
      insert(d3, t0 + j + 3, dd, ii);
    }
    for (; j < cnt; ++j) insert(sq_dist(ux, uy, uz, sx[j], sy[j], sz[j]), t0 + j, dd, ii);
  }
  if (!active) return;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float* p = seeds + static_cast<long long>(ii[s]) * 3;
    dist[row * 3 + s] = __fsqrt_rn(sq_dist(ux, uy, uz, p[0], p[1], p[2]));
    idx[row * 3 + s] = ii[s];
  }
}

}  // namespace

// unknown: (b, n, 3) f32; known: (b, m, 3) f32, m >= 1; dist: (b, n, 3)
// f32 and idx: (b, n, 3) int32, written in full.
extern "C" int three_nn_launch(const float* unknown, const float* known, float* dist, int* idx,
                               int b, int n, int m, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_scene = (n + kThreads - 1) / kThreads;
  if (static_cast<long long>(b) * per_scene > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  three_nn_kernel<<<b * per_scene, kThreads, 0, stream>>>(unknown, known, dist, idx, n, m,
                                                          per_scene);
  return static_cast<int>(cudaGetLastError());
}
