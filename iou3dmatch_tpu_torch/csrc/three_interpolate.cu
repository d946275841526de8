// Inverse-distance interpolation over three neighbours, the forward of
// feature propagation: out[b, q, :] = w0 f[b, i0, :] + w1 f[b, i1, :] +
// w2 f[b, i2, :], each index clamped to [0, m - 1].
//
// Replaces the XLA program of iou3dmatch_tpu/ops/interpolate.py::
// three_interpolate (:111, its forward _interp_fwd :131), a gather of three
// rows and a weighted sum. FP1 and FP2 run it on every path: (B, 256, 256)
// onto 512 queries and (B, 512, 256) onto 1,024, B 8 or 12. Its backward
// (_interp_bwd :137) is csrc/gather_bwd.cu's weighted sum,
// three_interpolate_bwd_launch.
//
// What bounds it on the H100: bytes. Each query's three rows are read (from
// L2 mostly: a scene's table is 256 or 512 KB) and its output row written
// once; 12.8 MB at FP2 of 8 scenes, under 4 us at 3.35 TB/s. The plain
// version writes and reads a (B, n, 3, C) gather, 25 MB at FP2, twice. Here
// a warp takes a query: lanes 0-2 read its three indices and weights once
// and pass them on by shuffles, then each lane moves 16-byte pieces of the
// channels (kVec = 4 where C is a multiple of 4 and the rows are 16-byte
// aligned, single floats otherwise) from the three rows to the output row.
// Nothing is materialised, nothing is atomic.
//
// Exactness: the plain version (ops/interpolate.py::three_interpolate_plain)
// multiplies each gathered row by its weight and sums the three products in
// order from the sum's identity, ((0 + p0) + p1) + p2; each product and sum
// is rounded on its own here (__fmul_rn, __fadd_rn, and the file is built
// with -fmad=false), so the output is the plain version's bit for bit, the
// sign of a zero included.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ((0 + p0) + p1) + p2, as PyTorch's sum from its identity 0: the same
// value as (p0 + p1) + p2, but +0 where every product is -0
__device__ __forceinline__ float lerp3(float a, float b, float c, float w0, float w1, float w2) {
  const float s = __fadd_rn(__fadd_rn(0.f, __fmul_rn(a, w0)), __fmul_rn(b, w1));
  return __fadd_rn(s, __fmul_rn(c, w2));
}

template <int kVec>
struct Piece;
template <>
struct Piece<1> {
  using T = float;
  __device__ static T mix(T a, T b, T c, float w0, float w1, float w2) {
    return lerp3(a, b, c, w0, w1, w2);
  }
};
template <>
struct Piece<4> {
  using T = float4;
  __device__ static T mix(T a, T b, T c, float w0, float w1, float w2) {
    return make_float4(lerp3(a.x, b.x, c.x, w0, w1, w2), lerp3(a.y, b.y, c.y, w0, w1, w2),
                       lerp3(a.z, b.z, c.z, w0, w1, w2), lerp3(a.w, b.w, c.w, w0, w1, w2));
  }
};

// A warp a query of the b * n, each lane kVec channels at a time.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
three_interpolate_kernel(const float* __restrict__ f, const int* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out, long long queries,
                         int n, int m, int c) {
  using T = typename Piece<kVec>::T;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (q >= queries) return;  // warp-uniform
  const long long scene = q / n;
  int my_i = 0;
  float my_w = 0.f;
  if (lane < 3) {
    my_i = min(max(idx[q * 3 + lane], 0), m - 1);
    my_w = w[q * 3 + lane];
  }
  const int i0 = __shfl_sync(kFull, my_i, 0), i1 = __shfl_sync(kFull, my_i, 1),
            i2 = __shfl_sync(kFull, my_i, 2);
  const float w0 = __shfl_sync(kFull, my_w, 0), w1 = __shfl_sync(kFull, my_w, 1),
              w2 = __shfl_sync(kFull, my_w, 2);
  const int pieces = c / kVec;
  const T* r0 = reinterpret_cast<const T*>(f + (scene * m + i0) * c);
  const T* r1 = reinterpret_cast<const T*>(f + (scene * m + i1) * c);
  const T* r2 = reinterpret_cast<const T*>(f + (scene * m + i2) * c);
  T* o = reinterpret_cast<T*>(out + q * c);
  for (int j = lane; j < pieces; j += 32) {
    o[j] = Piece<kVec>::mix(r0[j], r1[j], r2[j], w0, w1, w2);
  }
}

}  // namespace

// features: (b, m, c) f32; idx: (b, n, 3) i32; weight: (b, n, 3) f32; out:
// (b, n, c) f32, written in full. vec 4 takes 16-byte pieces (c % 4 == 0,
// features and out 16-byte aligned), vec 1 single floats. Returns
// cudaErrorInvalidValue for a shape the kernel cannot take.
extern "C" int three_interpolate_launch(const float* features, const int* idx, const float* weight,
                                        float* out, int b, int n, int m, int c, int vec,
                                        cudaStream_t stream) {
  const long long queries = static_cast<long long>(b) * n;
  const long long blocks = (queries + kWarps - 1) / kWarps;
  if (b < 1 || n < 1 || m < 1 || c < 1 || blocks >= (1LL << 31) ||
      (vec != 1 && vec != 4) || c % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4) {
    three_interpolate_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        features, idx, weight, out, queries, n, m, c);
  } else {
    three_interpolate_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        features, idx, weight, out, queries, n, m, c);
  }
  return static_cast<int>(cudaGetLastError());
}
