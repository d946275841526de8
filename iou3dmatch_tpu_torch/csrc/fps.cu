// Furthest point sampling, one thread block per scene.
//
// Replaces the Pallas kernel iou3dmatch_tpu/ops/fps_pallas.py::_fps_kernel
// (dispatched from iou3dmatch_tpu/ops/fps.py::furthest_point_sample).
// Semantics: seed index 0; points with |p|^2 <= 1e-3 are never chosen; a
// running min of squared distances to the chosen set; each step takes the
// argmax, the lowest index winning on equal values.
//
// What bounds it on the H100: the npoint-1 dependent steps. Each step is a
// full pass over the scene's points followed by a block-wide (value, index)
// argmax, and the next step cannot start before the argmax is known. The
// arithmetic (about 10 flops per point per step) and the bytes (the cloud
// once in, the indices once out) are far below the card's rates; the chain
// of block-wide reductions and the re-reads of the cloud from L2 are what
// take the time. At 40,000 points the coordinates (480 KB) and the
// min-distances (160 KB) exceed one block's 227 KB of shared memory, so the
// coordinates are read from global memory every step (they stay in L2) and
// the min-distances live in a global scratch row that only the owning
// thread touches. Only B of the 132 SMs are busy; splitting a scene over a
// thread-block cluster is left for later work.
//
// Distances are rounded product by product (__fmul_rn / __fadd_rn), so no
// FMA contraction changes a near-tie against the plain PyTorch version.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (v, i) takes (ov, oi) if ov is larger, or equal with a lower index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    take_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, float* __restrict__ mind,
           int* __restrict__ out, int n, int npoint) {
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* md = mind + static_cast<size_t>(blockIdx.x) * n;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_pick;

  // Invalid points hold -1 from the start: any distance (>= 0) keeps them
  // below every valid point, as the reference scan's best = -1 does.
  for (int k = threadIdx.x; k < n; k += kThreads) {
    md[k] = sq3(p[3 * k], p[3 * k + 1], p[3 * k + 2]) > 1e-3f ? 1e10f : -1.0f;
  }
  if (threadIdx.x == 0) o[0] = 0;

  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float px = p[3 * old], py = p[3 * old + 1], pz = p[3 * old + 2];
    float best = -INFINITY;
    int besti = INT_MAX;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float d = sq3(__fsub_rn(p[3 * k], px), __fsub_rn(p[3 * k + 1], py),
                          __fsub_rn(p[3 * k + 2], pz));
      const float m = fminf(md[k], d);
      md[k] = m;
      if (m > best) {  // k rises, so the first maximum in this thread stays
        best = m;
        besti = k;
      }
    }
    warp_argmax(best, besti);
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];  // kWarps == 32: one entry per lane
      besti = s_idx[lane];
      warp_argmax(best, besti);
      if (lane == 0) {
        s_pick = besti;
        o[j] = besti;
      }
    }
    __syncthreads();
    old = s_pick;
  }
}

static_assert(kWarps == 32, "the second reduction stage reads one entry per lane");

}  // namespace

// xyz: (b, n, 3) f32; mind: (b, n) f32 scratch; out: (b, npoint) i32.
extern "C" int fps_launch(const float* xyz, float* mind, int* out, int b, int n,
                          int npoint, cudaStream_t stream) {
  fps_kernel<<<b, kThreads, 0, stream>>>(xyz, mind, out, n, npoint);
  return static_cast<int>(cudaGetLastError());
}
