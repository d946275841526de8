// Ball query, one warp per center.
//
// Replaces the XLA program iou3dmatch_tpu/ops/ball_query.py::ball_query and
// its model-path form _ball_query_approx (a distance matmul followed by a
// top-k). There it is not a Pallas kernel; in the original 3DIoUMatch it
// was the CUDA kernel ball_query_gpu.cu, whose semantics this keeps: for
// each center, the first nsample points in scan order with d^2 < r^2
// (strict), where r^2 = f32(r) * f32(r); slots past the hit count repeat
// the first hit; a center with no hit gets index 0.
//
// What bounds it on the H100: reading the cloud. A warp walks the points in
// order, 32 at a time, tests them, and keeps scan order with a ballot and a
// population count; it stops as soon as it holds nsample hits, so the work
// is the prefix of the cloud each center needs, not the whole cloud. The
// clouds (480 KB a scene at 40,000 points) stay in L2 across the warps of a
// scene. No distance matrix is ever written.
//
// Distances are rounded product by product (__fmul_rn / __fadd_rn), so no
// FMA contraction moves a point across the radius against the plain
// PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int* __restrict__ out, int b, int n, int m, int nsample, float r2) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(b) * m) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const float* p = xyz + static_cast<size_t>(row / m) * n * 3;
  const float* c = centers + static_cast<size_t>(row) * 3;
  int* o = out + static_cast<size_t>(row) * nsample;
  const float cx = c[0], cy = c[1], cz = c[2];
  const unsigned below = (1u << lane) - 1u;

  int cnt = 0;
  int first = 0;
  for (int base = 0; base < n && cnt < nsample; base += 32) {
    const int k = base + lane;
    bool hit = false;
    if (k < n) {
      const float dx = __fsub_rn(cx, p[3 * k]);
      const float dy = __fsub_rn(cy, p[3 * k + 1]);
      const float dz = __fsub_rn(cz, p[3 * k + 2]);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (mask == 0u) continue;
    if (cnt == 0) first = base + __ffs(mask) - 1;
    const int slot = cnt + __popc(mask & below);
    if (hit && slot < nsample) o[slot] = k;
    cnt += __popc(mask);
  }
  const int fill = cnt > 0 ? first : 0;
  for (int s = min(cnt, nsample) + lane; s < nsample; s += 32) o[s] = fill;
}

}  // namespace

// xyz: (b, n, 3) f32; centers: (b, m, 3) f32; out: (b, m, nsample) i32.
extern "C" int ball_query_launch(const float* xyz, const float* centers, int* out, int b,
                                 int n, int m, int nsample, float r2,
                                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * m;
  const int blocks = static_cast<int>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(xyz, centers, out, b, n, m,
                                                                 nsample, r2);
  return static_cast<int>(cudaGetLastError());
}
