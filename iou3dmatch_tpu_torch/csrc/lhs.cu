// Lower-half suppression (LHS) of the teacher's pseudo labels: for each scene,
// over its K axis-aligned boxes, a bool keep mask.
//
// Replaces the XLA program iou3dmatch_tpu/geometry/nms.py::lhs_3d_samecls_jax
// (nms.py:115-167), vmapped over the unlabeled scenes by
// losses/unlabeled.py:196-198: K = 64 boxes a scene, 8 scenes at the SSL
// step. There it is a loop of K fixed rounds, each gated on whether any box
// remains; in plain PyTorch each round is about 20 small kernels.
//
// What bounds it on the H100: neither bytes (17 KB at the step) nor
// operations (at most 64 rounds of 64 boxes a scene, under 0.1 us at the
// card's instruction rate), but the launch and the rounds' chain of block
// barriers, about 1 us a round. So the whole loop runs in one
// launch, one block a scene, one thread a box (K <= 1024), with the boxes
// in shared memory:
//
// - Each round takes a block argmax of the remaining scores (a box that no
//   longer remains scores -inf; ties go to the higher index, as JAX's
//   argmax over the reversed scores), by warp shuffles and one pass over
//   the warps' winners.
// - Each remaining box computes its class-gated IoU with the winner and is
//   suppressed where it exceeds the threshold; __syncthreads_count gives
//   the cluster's size. The JAX function fills the K x K IoU matrix first;
//   here a box computes its entry of the winner's row when that row is
//   needed. The operations are the same, each pair's in the same order, and
//   the shared memory stays O(K), so every K up to 1,024 fits.
// - Each suppressed box counts the cluster boxes that rank above it (a
//   higher score, or an equal one at a higher index: nms.py:143-145) and is
//   kept back when its rank is below half the cluster's size.
// - The rounds stop once no box remains, where JAX's gated rounds change
//   nothing more.
//
// Exactness against JAX and the plain PyTorch version
// (geometry/nms.py::lhs_3d_samecls_plain): the area is (dx dy) dz + 1e-8
// with dx = max(hi - lo, 0), the intersection (ix iy) iz, the IoU
// inter / ((area_i + area_j) - inter), each product, sum and quotient
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; the file
// is built with -fmad=false, see ops/_build.py), and the class gate
// multiplies, so a box of another class has IoU 0 and is compared as such.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxBoxes = 1024;

__device__ __forceinline__ float clamp0(float x) { return x > 0.f ? x : 0.f; }

__device__ __forceinline__ float prod3(float x, float y, float z) {
  return __fmul_rn(__fmul_rn(x, y), z);
}

// (score, index) a beats (score, index) b: a higher score, or an equal one
// at a higher index
__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia > ib);
}

__global__ void lhs_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
                           const float* __restrict__ scores, const int* __restrict__ cls,
                           bool* __restrict__ keep_out, int k, float thresh) {
  extern __shared__ float smem[];
  float* lo = smem;              // [k][3]
  float* hi = lo + 3 * k;        // [k][3]
  float* area = hi + 3 * k;      // [k]
  float* score = area + k;       // [k]
  int* label = reinterpret_cast<int*>(score + k);  // [k]
  int* supp_of = label + k;      // [k]
  __shared__ float warp_score[32];
  __shared__ int warp_index[32];
  __shared__ int winner;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const bool box = t < k;
  const long long base = static_cast<long long>(blockIdx.x) * k;
  float my_lo[3] = {0.f, 0.f, 0.f}, my_hi[3] = {0.f, 0.f, 0.f};
  float my_area = 0.f, my_score = -CUDART_INF_F;
  int my_cls = 0;
  if (box) {
    for (int c = 0; c < 3; ++c) {
      my_lo[c] = mins[(base + t) * 3 + c];
      my_hi[c] = maxs[(base + t) * 3 + c];
      lo[t * 3 + c] = my_lo[c];
      hi[t * 3 + c] = my_hi[c];
    }
    my_area = __fadd_rn(prod3(clamp0(__fsub_rn(my_hi[0], my_lo[0])),
                              clamp0(__fsub_rn(my_hi[1], my_lo[1])),
                              clamp0(__fsub_rn(my_hi[2], my_lo[2]))), 1e-8f);
    my_score = scores[base + t];
    my_cls = cls[base + t];
    area[t] = my_area;
    score[t] = my_score;
    label[t] = my_cls;
  }
  bool remaining = box, keep = false;
  for (int round = 0; round < k; ++round) {
    if (!__syncthreads_or(remaining)) break;  // also orders the last round's reads
    // block argmax of the remaining scores, ties to the higher index
    float best = remaining ? my_score : -CUDART_INF_F;
    int at = box ? t : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, best, off);
      const int i = __shfl_down_sync(0xffffffffu, at, off);
      if (beats(s, i, best, at)) best = s, at = i;
    }
    if (lane == 0) warp_score[warp] = best, warp_index[warp] = at;
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < warps; ++w) {
        if (beats(warp_score[w], warp_index[w], best, at)) {
          best = warp_score[w];
          at = warp_index[w];
        }
      }
      winner = at;
    }
    __syncthreads();
    const int w = winner;

    // suppress the remaining boxes whose class-gated IoU with the winner
    // exceeds the threshold
    bool supp = false;
    if (remaining && t != w) {
      float side[3];
      for (int c = 0; c < 3; ++c) {
        side[c] = clamp0(__fsub_rn(fminf(hi[w * 3 + c], my_hi[c]), fmaxf(lo[w * 3 + c], my_lo[c])));
      }
      const float inter = prod3(side[0], side[1], side[2]);
      const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(area[w], my_area), inter));
      supp = (label[w] == my_cls ? iou : 0.f) > thresh;
    }
    if (box) supp_of[t] = supp;
    const int n_supp = __syncthreads_count(supp);
    if (supp) {
      int rank = 0;  // the cluster boxes that rank above this one
      for (int j = 0; j < k; ++j) {
        rank += supp_of[j] && (my_score < score[j] || (my_score == score[j] && t < j));
      }
      keep = keep || rank < n_supp / 2;
    }
    keep = keep || t == w;
    remaining = remaining && !supp && t != w;
  }
  if (box) keep_out[base + t] = keep;
}

}  // namespace

// mins, maxs: (b, k, 3) f32; scores: (b, k) f32; cls: (b, k) int32;
// keep: (b, k) bool, written in full.
extern "C" int lhs_launch(const float* mins, const float* maxs, const float* scores,
                          const int* cls, bool* keep, int b, int k, float thresh,
                          cudaStream_t stream) {
  if (b < 1 || k < 1 || k > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (k + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(k) * (8 * sizeof(float) + 2 * sizeof(int));
  lhs_kernel<<<b, threads, smem, stream>>>(mins, maxs, scores, cls, keep, k, thresh);
  return static_cast<int>(cudaGetLastError());
}
