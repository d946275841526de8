// Grouping gather, one warp per output row.
//
// Replaces the Pallas kernel iou3dmatch_tpu/ops/gather_pallas.py::_kernel
// (gather_rows_vmem, dispatched from ops/ball_query.py::group_points),
// which pinned each scene's table in TPU VMEM. Here it serves every
// group_points call of the detection forward at any width C:
// out[b, q, :] = table[b, clamp(idx[b, q], 0, n - 1), :].
//
// What bounds it on the H100: bytes. Each output row is written once and
// each index read once; the table rows it reads come mostly from L2 (the
// tables of a batch of 8 scenes are 4 to 9 MB). A warp copies its row with
// 16-byte loads and stores when C % 4 == 0 and the pointers are 16-byte
// aligned, with 4-byte ones otherwise. At C = 4 (SA1) one lane of the warp
// does the work, so narrow tables are bound by warp issue, not bytes;
// packing several rows into a warp is left for later work.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
              float* __restrict__ out, int b, int n, int q, int c) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(b) * q) return;
  const int lane = threadIdx.x & 31;
  const int k = min(max(idx[row], 0), n - 1);
  const float* src = table + (static_cast<size_t>(row / q) * n + k) * c;
  float* dst = out + static_cast<size_t>(row) * c;
  if (kVec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int j = lane; j < c / 4; j += 32) d4[j] = s4[j];
  } else {
    for (int j = lane; j < c; j += 32) dst[j] = src[j];
  }
}

}  // namespace

// table: (b, n, c) f32; idx: (b, q) i32; out: (b, q, c) f32. vec4 != 0 asks
// for 16-byte copies: the caller checks c % 4 == 0 and 16-byte alignment.
extern "C" int gather_launch(const float* table, const int* idx, float* out, int b, int n,
                             int q, int c, int vec4, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * q;
  const int blocks = static_cast<int>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (vec4) {
    gather_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(table, idx, out, b, n, q, c);
  } else {
    gather_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(table, idx, out, b, n, q, c);
  }
  return static_cast<int>(cudaGetLastError());
}
