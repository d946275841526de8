// Grouping gather, threads mapped to 16-byte pieces of the output.
//
// Replaces the Pallas kernel iou3dmatch_tpu/ops/gather_pallas.py::_kernel
// (gather_rows_vmem, dispatched from ops/ball_query.py::group_points),
// which pinned each scene's table in TPU VMEM. Here it serves every
// group_points call of the detection forward at any width C:
// out[b, q, :] = table[b, clamp(idx[b, q], 0, n - 1), :].
//
// What bounds it on the H100: bytes. Each output element is written once
// and each index read once; the table rows come mostly from L2 (the tables
// of a batch of 8 scenes are 4 to 9 MB). The forward gathers at C = 4 (SA1),
// 131 (SA2) and 259 (SA3, SA4, vote aggregation, GridConv), so rows are
// either one 16-byte piece or not a multiple of 16 bytes at all. Work is
// cut by the output's bytes, not its rows, so a narrow row does not leave a
// warp idle: the output is one flat f32 array and each thread writes one
// aligned float4 of it, so a warp stores 512 contiguous bytes. Its 4
// elements fall in one or two rows (up to four when C < 4); the thread
// loads those rows' indices and then the 4 table elements, scalar loads
// that neighbouring threads serve from the same L1/L2 lines. The tail of
// B*Q*C that is not a multiple of 4 is stored element by element. At C = 4
// this moves a row with one index load, four 4-byte table loads from one
// 16-byte piece and one 16-byte store. A second kernel with one float4 table
// load a row for C % 4 == 0 was 4 % faster at SA1, about 0.35 us of a 20 ms
// forward (PERF.md), which does not pay for a second code path.
//
// Each thread takes kUnroll pieces, a block apart, and issues all their
// loads before its stores, to keep several misses in flight. 128 threads and
// 2 pieces a thread were the fastest of the block sizes and unrolls tried on
// the forward's six shapes (PERF.md): each index load and the table load
// that depends on it are two L2 round trips, which many small blocks hide
// best.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;

template <typename I>
__device__ __forceinline__ const float* row_src(const float* table, const int* idx, I row,
                                                int n, int q, int c) {
  const int k = min(max(idx[row], 0), n - 1);
  return table + (static_cast<size_t>(row / q) * n + k) * c;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_flat_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int n, int q, int c, I total) {
  float v[kUnroll][4];
  I first[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    first[u] = ((static_cast<I>(blockIdx.x) * kUnroll + u) * kThreads + threadIdx.x) * 4;
    if (first[u] < total) {
      I row = first[u] / c;
      int col = static_cast<int>(first[u] - row * c);
      const float* src = row_src(table, idx, row, n, q, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (first[u] + e < total) {
          v[u][e] = src[col];
          if (++col == c && e < 3 && first[u] + e + 1 < total) {
            col = 0;
            src = row_src(table, idx, ++row, n, q, c);
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (first[u] + 3 < total) {
      *reinterpret_cast<float4*>(out + first[u]) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 3; ++e) {  // constant indices keep v in registers
        if (first[u] + e < total) out[first[u] + e] = v[u][e];
      }
    }
  }
}

template <typename I>
int launch(const float* table, const int* idx, float* out, int n, int q, int c, long long rows,
           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long total = rows * c;
  const long long blocks = ((total + 3) / 4 + per_block - 1) / per_block;
  gather_flat_kernel<I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, idx, out, n, q, c, static_cast<I>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: (b, n, c) f32; idx: (b, q) i32; out: (b, q, c) f32, 16-byte
// aligned.
extern "C" int gather_launch(const float* table, const int* idx, float* out, int b, int n,
                             int q, int c, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * q;
  // 32-bit index arithmetic when every flat offset, with a block's overshoot, fits
  if (rows * c + 4LL * kThreads * kUnroll < (1LL << 31)) {
    return launch<int>(table, idx, out, n, q, c, rows, stream);
  }
  return launch<long long>(table, idx, out, n, q, c, rows, stream);
}
