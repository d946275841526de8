// Backward of the grouping gather: a segment sum of the cotangent rows into
// the table rows they were gathered from,
// grad_table[b, clamp(idx[b, u], 0, n - 1), :] += g[b, u, :].
//
// Replaces the custom VJP of iou3dmatch_tpu/ops/ball_query.py::group_points
// (_group_bwd -> ops/scatter.py::batched_onehot_segment_sum), which wrote
// the scatter-add as a one-hot matmul for the TPU's matrix unit, because a
// TPU scatter serializes. Here it is a scatter with f32 atomic adds. The
// pretrain step runs it four times (SA2, SA3, SA4 and vote aggregation; SA1's
// table is the point cloud and GridConv's seeds are detached, so neither
// needs it).
//
// What bounds it on the H100: bytes. Each element of g is read once and
// added once; the output (2 to 9 MB at the step's shapes) is zeroed by the
// caller and stays in the 50 MB L2, where the adds land. The first version
// is simple: each thread takes kUnroll elements of the flat g, a block
// apart so that a warp reads 128 contiguous bytes, loads their row's index
// and adds with atomicAdd, which compiles to a fire-and-forget RED.ADD.F32
// since its result is unused. C is 3, 131 or 259 on the step, odd, so no
// vector atomic fits a row. Slots of a ball with fewer than nsample hits
// repeat its first hit, so SA4 and vote aggregation send many adds to a few
// rows; pre-summing equal indices within a warp is left for a later change.
// The order of the atomics, and so the last bits of each sum, change from
// run to run. Offsets are 64-bit where B * U * C or B * N * C may pass 2^31.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  float* __restrict__ out, int n, int u, int c, I total) {
  const I base = static_cast<I>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
  float v[kUnroll];
  I dst[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const I e = base + static_cast<I>(k) * kThreads;
    dst[k] = -1;
    if (e < total) {
      const I row = e / c;  // (b, slot) of the cotangent
      const I b = row / u;
      const int t = min(max(idx[row], 0), n - 1);
      v[k] = g[e];
      dst[k] = (b * n + t) * c + (e - row * c);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (dst[k] >= 0) atomicAdd(out + dst[k], v[k]);
  }
}

template <typename I>
int launch(const float* g, const int* idx, float* out, int n, int u, int c, long long total,
           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long blocks = (total + per_block - 1) / per_block;
  gather_bwd_kernel<I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      g, idx, out, n, u, c, static_cast<I>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (b, u, c) f32; idx: (b, u) i32; out: (b, n, c) f32, zeroed by the
// caller on the same stream.
extern "C" int gather_bwd_launch(const float* g, const int* idx, float* out, int b, int n, int u,
                                 int c, cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * u * c;
  const long long table = static_cast<long long>(b) * n * c;
  // 32-bit index arithmetic when every flat offset, with a block's overshoot, fits
  if (total + static_cast<long long>(kThreads) * kUnroll < (1LL << 31) && table < (1LL << 31)) {
    return launch<int>(g, idx, out, n, u, c, total, stream);
  }
  return launch<long long>(g, idx, out, n, u, c, total, stream);
}
