// Ball query: each block stages its scene's cloud in shared memory, tile by
// tile, and tests every staged point against the centers its warps hold.
//
// Replaces the XLA program iou3dmatch_tpu/ops/ball_query.py::ball_query and
// its model-path form _ball_query_approx (a distance matmul followed by a
// top-k). There it is not a Pallas kernel; in the original 3DIoUMatch it
// was the CUDA kernel ball_query_gpu.cu, whose semantics this keeps: for
// each center, the first nsample points in scan order with d^2 < r^2
// (strict), where r^2 = f32(r) * f32(r); slots past the hit count repeat
// the first hit; a center with no hit gets index 0.
//
// What bounds it on the H100: issuing the distance tests of a brute-force
// scan. A center scans the cloud in index order until it holds nsample
// hits; in a room of uniform points no ball of r 0.2 holds 64 of 40,000
// points, so every center scans the whole cloud, and each (center, point)
// pair costs 9 instructions (3 sub, 3 mul, 2 add, 1 compare) that no FMA
// may fuse. Reading the cloud is no bound once it is shared: a block loads
// each point once for all its centers. The function itself needs far less:
// a spatial grid of r-sized cells would test only the points of the 27
// cells around a center, about 1/500 of the pairs at SA1, so this kernel
// runs far from what the function needs (PERF.md, the grid question).
//
// The design. A block holds G = 8 warps x C centers of one scene, C a
// warp, with their coordinates, hit counts and first hits in registers.
// The scene's cloud streams through shared memory in tiles of `tile`
// points, double-buffered, with cp.async (16-byte copies where the scene
// starts on a 16-byte boundary, else 4-byte). For each 32-point chunk of a
// tile each lane loads one point and tests it against the warp's C
// centers, folding the C compares into one predicate (FSETP.OR); one
// __any_sync per chunk decides whether any center hit. Only then does the
// warp take one ballot per center, and the slot of a hit is count +
// popc(ballot & lanes below), as one warp per center did before. So a
// chunk with no hit costs 9 C + 12 warp instructions (84 at C = 8 in the
// compiled loop: 3 shared loads, the vote and the loop amortize over C
// centers), against the 9 C of the scan. Chunks and tiles are walked in
// index order, so scan order holds. A larger C amortizes more but leaves
// fewer warps to hide latency: SA1's 16,384 centers make 4 warps a
// scheduler at C = 8, and C = 16 (2 a scheduler) was 29 % slower, so it is
// not built (PERF.md).
//
// Early exit, and what it costs. A full center's x becomes NaN, so it hits
// nothing more and stops waking the ballot path; a warp stops testing once
// all its C centers are full, and the block stops loading tiles once every
// warp has stopped (__syncthreads_or at each tile boundary). A block thus
// scans as long as its slowest center, where one warp per center stopped
// each center on its own: on clouds where some balls fill early and others
// never do, the early exit saves less than it did.
//
// Distances are rounded product by product (__fmul_rn / __fadd_rn), so no
// FMA contraction moves a point across the radius against the plain
// PyTorch version.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // ops/ball_query.py WARPS

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Starts copying points [first, first + count) of a scene into dst as one
// cp.async group, and pads dst to a whole 32-point chunk with NaN points,
// which never hit. `vec`: the scene starts on a 16-byte boundary, so every
// tile does too (tiles are multiples of 32 points).
__device__ __forceinline__ void stage(float* dst, const float* scene, int first, int count,
                                      bool vec) {
  const float* src = scene + 3 * static_cast<size_t>(first);
  const int nf = 3 * count;
  const int nv = vec ? nf >> 2 : 0;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * nv + threadIdx.x; i < nf; i += blockDim.x) cp_async4(dst + i, src + i);
  for (int i = nf + threadIdx.x; i < 3 * ((count + 31) & ~31); i += blockDim.x)
    dst[i] = CUDART_NAN_F;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float dist2(float cx, float cy, float cz, float px, float py,
                                       float pz) {
  const float dx = __fsub_rn(cx, px);
  const float dy = __fsub_rn(cy, py);
  const float dz = __fsub_rn(cz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// grid b x ceil(m / G) blocks, scene-major in blockIdx.x (any b);
// blockDim.x = 32 x kWarps; 2 x tile x 12 bytes of dynamic shared memory.
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int* __restrict__ out, int n, int m, int nsample, float r2, int tile) {
  extern __shared__ __align__(16) float buf[];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int per_scene = (m + kWarps * C - 1) / (kWarps * C);
  const size_t scene = blockIdx.x / per_scene;
  const float* p = xyz + scene * n * 3;
  const int row0 = ((blockIdx.x % per_scene) * kWarps + (threadIdx.x >> 5)) * C;  // in the scene
  int* o = out + (scene * m + row0) * nsample;

  float cx[C], cy[C], cz[C];
  int cnt[C], first[C];
  int live = 0;  // centers still short of nsample hits; uniform across the warp
#pragma unroll
  for (int j = 0; j < C; ++j) {
    cnt[j] = first[j] = 0;
    cx[j] = cy[j] = cz[j] = CUDART_NAN_F;  // past m: never hits, never written
    if (row0 + j < m) {
      const float* c = centers + (scene * m + row0 + j) * 3;
      cx[j] = c[0], cy[j] = c[1], cz[j] = c[2];
      ++live;
    }
  }

  const bool vec = (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  const int tiles = (n + tile - 1) / tile;
  stage(buf, p, 0, min(tile, n), vec);
  bool done = live == 0;
  for (int t = 0; t < tiles; ++t) {
    const int base = t * tile;
    if (t + 1 < tiles) {
      stage(buf + ((t + 1) & 1) * 3 * tile, p, base + tile, min(tile, n - base - tile), vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory for every warp
    if (!done) {
      // k0: index of the chunk's first point; q: this lane's point
      const float* q = buf + (t & 1) * 3 * tile + 3 * lane;
      const int end = base + min(tile, n - base);
      for (int k0 = base; k0 < end; k0 += 32, q += 3 * 32) {
        const float px = q[0], py = q[1], pz = q[2];
        bool any = false;
#pragma unroll
        for (int j = 0; j < C; ++j) any |= dist2(cx[j], cy[j], cz[j], px, py, pz) < r2;
        if (!__any_sync(kFull, any)) continue;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const bool hit = dist2(cx[j], cy[j], cz[j], px, py, pz) < r2;
          const unsigned mask = __ballot_sync(kFull, hit);
          if (mask == 0u) continue;
          if (cnt[j] == 0) first[j] = k0 + __ffs(mask) - 1;
          const int slot = cnt[j] + __popc(mask & below);
          if (hit && slot < nsample) o[j * nsample + slot] = k0 + lane;
          cnt[j] += __popc(mask);
          if (cnt[j] >= nsample) {
            cx[j] = CUDART_NAN_F;
            --live;
          }
        }
        if (live == 0) break;
      }
      done = live == 0;
    }
    // every warp is done with tile t before iteration t + 1 restages its buffer
    if (!__syncthreads_or(!done)) break;
  }
  cp_async_wait<0>();  // a block that stopped early leaves no copy in flight

#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (row0 + j >= m) break;
    const int fill = cnt[j] > 0 ? first[j] : 0;
    for (int s = min(cnt[j], nsample) + lane; s < nsample; s += 32) o[j * nsample + s] = fill;
  }
}

template <int C>
cudaError_t launch(const float* xyz, const float* centers, int* out, int b, int n, int m,
                   int nsample, float r2, int tile, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(b) * ((m + kWarps * C - 1) / (kWarps * C));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // gridDim.x's limit
  const size_t smem = 2 * static_cast<size_t>(tile) * 3 * sizeof(float);
  ball_query_kernel<C><<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      xyz, centers, out, n, m, nsample, r2, tile);
  return cudaGetLastError();
}

}  // namespace

// xyz: (b, n, 3) f32; centers: (b, m, 3) f32; out: (b, m, nsample) i32.
// C = centers_per_warp must be one of ops/ball_query.py BQ_CENTERS; tile is
// a multiple of 32 points.
extern "C" int ball_query_launch(const float* xyz, const float* centers, int* out, int b,
                                 int n, int m, int nsample, float r2, int centers_per_warp,
                                 int tile, cudaStream_t stream) {
  cudaError_t err;
  switch (centers_per_warp) {
    case 1: err = launch<1>(xyz, centers, out, b, n, m, nsample, r2, tile, stream); break;
    case 2: err = launch<2>(xyz, centers, out, b, n, m, nsample, r2, tile, stream); break;
    case 4: err = launch<4>(xyz, centers, out, b, n, m, nsample, r2, tile, stream); break;
    case 8: err = launch<8>(xyz, centers, out, b, n, m, nsample, r2, tile, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
