// Greedy non-maximum suppression over each scene's K boxes: a bool keep mask.
//
// Replaces the XLA program iou3dmatch_tpu/geometry/nms.py::_nms_jax
// (nms.py:170-191, behind nms_rotated_jax :194 and nms_normal_jax :205),
// and serves the eval path's three NumPy NMS branches of parse_predictions
// (iou3dmatch_tpu/eval/ap_helper.py:95-135, nms.py:14-107), which the JAX
// package runs on the host, one scene at a time. One launch takes all B
// scenes of a request, a block a scene. Two entry points share one scan:
//
// - box mode (nms_boxes_launch): the block computes each pair's overlap from
//   the boxes' camera-frame bounds, as _nms_loop does: 2D over axes x and z
//   (nms_2d_faster), 3D (nms_3d_faster), or 3D gated on equal classes
//   (nms_3d_faster_samecls), the first two in float32 and the class-aware one
//   in float64, as the JAX package's NumPy arrays are there;
// - matrix mode (nms_matrix_launch): the overlap is a given (K, K) float32
//   IoU matrix, compared in float32, as _nms_jax does.
//
// What bounds it on the H100: neither bytes (a few KB a scene in box mode)
// nor operations (K^2 / 2 overlaps, well under a microsecond at the card's
// rates even in float64), but the chain of rounds, each waiting on the last.
// So the rounds run in one launch, on one thread, over bits:
//
// 1. Order once. Two threads a box count the boxes whose 64-bit key is
//    larger: that count is the box's position in the pick order. Box mode's
//    key puts NaN scores first, then the higher score, ties (and NaN among
//    themselves) to the higher index: np.argsort(kind="stable") read from the
//    back, the port's rule (geometry/nms.py). Matrix mode's key breaks ties
//    to the lower index, as jnp.argmax takes the first maximum and NaN as the
//    largest. Boxes outside `valid` get key 0 and no position.
// 2. The suppression matrix. Warp w fills the rows of positions w, w + 16,
//    ...; lane l the columns l, l + 32, ...; a bit where the column's position
//    comes after the row's and the row's box, as the winner, suppresses the
//    column's box. One 32-bit ballot a row and column group: K = 256 is 8
//    words a row, 8 KB a scene. Most pairs of a scene do not meet; their
//    overlap is 0 without a division (see below).
// 3. The rounds, on one thread, in one scan over the positions without a
//    branch: a position not yet removed when the scan reaches it is the
//    round's winner (every earlier one is gone), and its row joins the
//    removed mask, four 64-bit words held in registers. The rows' loads do
//    not wait on the scan, so the chain from one position to the next is a
//    test and a few masks. Matrix mode keeps _nms_jax's rule for an all
//    -inf remainder: its masked argmax then picks the first valid box,
//    remaining or not, and the rounds after it change nothing. A first
//    design ran the rounds on a warp, one trip a winner (ballot, find the
//    first open word, shuffle, load the row): on an H100 SXM at 700 W it
//    took 30.7 us at (8, 128) class-aware with 95 winners a scene, and 17.5
//    us in 2D with 35 (PERF.md §6).
//
// Exactness against NumPy, JAX and the plain versions (geometry/nms.py::
// nms_boxes_plain, nms_masked_plain): each side is max(0, min(hi_i, hi_r) -
// max(lo_i, lo_r)) with NaN carried through as np.minimum and np.maximum
// carry it; the area ((dx dy) dz) or dx dz, unclamped; inter the product of
// the sides in the same order; o = inter / ((area_i + area_r) - inter), or
// inter / area_r for old_type; times the class gate; o > thresh with thresh
// rounded to the mode's type. Every product, sum and quotient is rounded on
// its own (__fmul_rn ... __ddiv_rn; the file is built with -fmad=false, see
// ops/_build.py), so given the same float32 bounds each overlap is NumPy's
// bit for bit, and a NaN overlap suppresses nothing. The min and max carry a
// NaN bound through only in a scene that has one: elsewhere one fminf or
// fmaxf gives the same. Where the intersection
// is 0 the quotient is 0, or NaN when its divisor is 0 or NaN, whichever
// sign: it exceeds thresh exactly when the divisor is neither and 0 >
// thresh, which is tested without dividing (a zero dividend sends
// __fdiv_rn down its slow path).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#ifdef NMS_PHASES
// Built so by chip_smoke.py's NMS rows: thread 0 of each block stamps
// clock64() at its start and after each step, read back by nms_phases_read.
// The kernel's own build leaves the stamps out.
__device__ long long nms_phase_clock[4096][5];
#define NMS_STAMP(n) \
  if (threadIdx.x == 0 && blockIdx.x < 4096) nms_phase_clock[blockIdx.x][n] = clock64()
#else
#define NMS_STAMP(n)
#endif

namespace {

constexpr int kMaxBoxes = 256;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWords64 = kMaxBoxes / 64;  // 64-bit words a row of the matrix
constexpr int kSortThreads = kThreads / kMaxBoxes;
static_assert(kSortThreads >= 1 && (kSortThreads & (kSortThreads - 1)) == 0, "a power of two");

enum Mode { k2D = 0, k3D = 1, k3DCls = 2, kMatrix = 3 };

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }

// np.minimum, np.maximum and np.maximum(0, x): a NaN operand gives NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (a != a || b != b) ? a + b : (a < b ? a : b); }
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (a != a || b != b) ? a + b : (a > b ? a : b); }
template <typename T>
__device__ __forceinline__ T clamp0(T x) { return x > T(0) || x != x ? x : T(0); }
// the same without a NaN operand: one min or max instruction
__device__ __forceinline__ float fast_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float fast_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fast_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double fast_max(double a, double b) { return fmax(a, b); }

// whether the winner at position r suppresses the box at position c, in
// _nms_loop's order of operations; kNan: some bound of the scene is NaN, so
// min and max carry NaN as np.minimum and np.maximum do
template <typename T, int kAxes, bool kGated, bool kNan>
__device__ __forceinline__ bool suppresses(const T (*lo)[kAxes], const T (*hi)[kAxes],
                                           const T* area, const long long* label, int r, int c,
                                           int old_type, double thresh) {
  T side[kAxes];
  for (int a = 0; a < kAxes; ++a) {
    side[a] = kNan ? clamp0(sub(nan_min(hi[r][a], hi[c][a]), nan_max(lo[r][a], lo[c][a])))
                   : fast_max(sub(fast_min(hi[r][a], hi[c][a]), fast_max(lo[r][a], lo[c][a])), T(0));
  }
  T inter = mul(side[0], side[1]);
  if constexpr (kAxes == 3) inter = mul(inter, side[2]);
  const T den = old_type ? area[c] : sub(add(area[r], area[c]), inter);
  if (inter == T(0)) return den != T(0) && den == den && T(0) > static_cast<T>(thresh);
  T o = quo(inter, den);
  if constexpr (kGated) o = mul(o, label[r] == label[c] ? T(1) : T(0));
  return o > static_cast<T>(thresh);
}

// the pick order as one unsigned compare: a larger key goes first. The
// score's bits map to an order-keeping unsigned int, -0 taken as +0 and every
// NaN above +inf; `low` breaks ties.
__device__ __forceinline__ unsigned long long order_key(float s, int low) {
  const unsigned int u = __float_as_uint(s == 0.f ? 0.f : s);
  const unsigned int o = isnan(s) ? 0xffffffffu : (u & 0x80000000u ? ~u : u | 0x80000000u);
  return static_cast<unsigned long long>(o) << 32 | static_cast<unsigned int>(low);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
           const float* __restrict__ iou, const float* __restrict__ scores,
           const long long* __restrict__ cls, const bool* __restrict__ valid,
           bool* __restrict__ keep_out, int k, double thresh, int old_type) {
  using T = typename std::conditional<kMode == k3DCls, double, float>::type;
  constexpr int kAxes = kMode == k2D ? 2 : 3;  // 2D: axes x and z
  // by position in the pick order
  __shared__ unsigned long long key_of[kMaxBoxes];  // by box index
  __shared__ T lo[kMaxBoxes][kAxes];
  __shared__ T hi[kMaxBoxes][kAxes];
  __shared__ T area[kMaxBoxes];
  __shared__ long long label[kMaxBoxes];
  __shared__ int box_at[kMaxBoxes];
  __shared__ int pos_of[kMaxBoxes];  // by box index
  __shared__ bool ninf_at[kMaxBoxes];
  __shared__ unsigned long long row_of[kMaxBoxes][kWords64];  // the later positions it suppresses
  __shared__ unsigned long long won[kWords64];
  __shared__ int first_box;

  NMS_STAMP(0);
  // (1) order once
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i = t / kSortThreads, part = t % kSortThreads;
  const bool box = i < k;
  const long long at = static_cast<long long>(blockIdx.x) * k + (box ? i : 0);
  const bool ok = box && (valid == nullptr || valid[at]);
  const float s = scores[at];
  const unsigned long long key = ok ? order_key(s, kMode == kMatrix ? k - 1 - i : i) : 0ull;
  if (t == 0) first_box = k;
  if (box && part == 0) key_of[i] = key;
  __syncthreads();
  if (ok && part == 0) atomicMin(&first_box, i);
  int p = 0;
  for (int j = part; j < k; j += kSortThreads) p += key_of[j] > key;
  for (int off = kSortThreads / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
  const int n = __syncthreads_count(ok && part == 0);  // the valid boxes
  bool has_nan = false;
  if (ok && part == 0) {
    box_at[p] = i;
    pos_of[i] = p;
    ninf_at[p] = s == -CUDART_INF_F;
    if constexpr (kMode != kMatrix) {
      T d[kAxes];
      for (int a = 0; a < kAxes; ++a) {
        const int axis = kAxes == 2 && a == 1 ? 2 : a;
        lo[p][a] = static_cast<T>(mins[at * 3 + axis]);
        hi[p][a] = static_cast<T>(maxs[at * 3 + axis]);
        d[a] = sub(hi[p][a], lo[p][a]);
        has_nan = has_nan || d[a] != d[a];  // a NaN bound, or inf - inf
      }
      T ar = mul(d[0], d[1]);
      if constexpr (kAxes == 3) ar = mul(ar, d[2]);
      area[p] = ar;
      if constexpr (kMode == k3DCls) label[p] = cls[at];
    }
  }
  const bool any_nan = __syncthreads_or(has_nan);
  NMS_STAMP(1);

  // (2) the suppression matrix, by position: only columns after the row
  const float thresh_f = static_cast<float>(thresh);
  for (int r = warp; r < n; r += kWarps) {
    for (int g = 0; g * 32 < n; ++g) {
      const int c = g * 32 + lane;
      bool over = false;
      if (c > r && c < n) {
        if constexpr (kMode == kMatrix) {
          const long long row = static_cast<long long>(blockIdx.x) * k + box_at[r];
          over = iou[row * k + box_at[c]] > thresh_f;
        } else {
          constexpr bool kGated = kMode == k3DCls;
          over = any_nan ? suppresses<T, kAxes, kGated, true>(lo, hi, area, label, r, c, old_type, thresh)
                         : suppresses<T, kAxes, kGated, false>(lo, hi, area, label, r, c, old_type, thresh);
        }
      }
      const unsigned int word = __ballot_sync(0xffffffffu, over);
      if (lane == 0) reinterpret_cast<unsigned int*>(row_of[r])[g] = word;
    }
  }
  __syncthreads();
  NMS_STAMP(2);

  // (3) the rounds: one scan over the positions; a position not yet removed
  // when the scan reaches it wins
  if (t == 0) {
    unsigned long long removed[kWords64], mine[kWords64];
    for (int v = 0; v < kWords64; ++v) removed[v] = mine[v] = 0ull;
    const int pf = n > 0 ? pos_of[first_box] : 0;
    bool stuck = false;  // matrix mode: every remaining box scores -inf
#pragma unroll
    for (int w = 0; w < kWords64; ++w) {
#pragma unroll
      for (int b = 0; b < 64; ++b) {  // unrolled: each position's bit a constant
        const int q = w * 64 + b;
        if (q >= n) break;
        const unsigned long long bit = 1ull << b;
        bool wins = !(removed[w] & bit);
        if constexpr (kMode == kMatrix) {
          stuck = stuck || (wins && ninf_at[q] && q != pf);
          wins = wins && !stuck;
        }
        // a mask, not a select: a `wins ? load : 0` compiles to a load that
        // waits for `wins` (ROADMAP.md, hazards), where these loads need not
        const unsigned long long take = 0ull - static_cast<unsigned long long>(wins);
#pragma unroll
        for (int v = w; v < kWords64; ++v) removed[v] |= row_of[q][v] & take;
        mine[w] |= bit & take;
      }
    }
    if constexpr (kMode == kMatrix) {
      // the first valid box wins, and no later round changes anything
#pragma unroll
      for (int v = 0; v < kWords64; ++v) mine[v] |= stuck && v == pf >> 6 ? 1ull << (pf & 63) : 0ull;
    }
    for (int v = 0; v < kWords64; ++v) won[v] = mine[v];
  }
  __syncthreads();
  NMS_STAMP(3);
  if (box && part == 0) keep_out[at] = ok && (won[p >> 6] >> (p & 63) & 1ull);
  NMS_STAMP(4);
}

template <int kMode>
int launch(const float* mins, const float* maxs, const float* iou, const float* scores,
           const long long* cls, const bool* valid, bool* keep, int b, int k, double thresh,
           int old_type, cudaStream_t stream) {
  nms_kernel<kMode><<<b, kThreads, 0, stream>>>(mins, maxs, iou, scores, cls, valid, keep, k,
                                                thresh, old_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mins, maxs: (b, k, 3) f32; scores: (b, k) f32; cls: (b, k) int64 (mode 2
// only, else may be null); valid: (b, k) bool or null; keep: (b, k) bool,
// written in full. mode: 0 2D (x, z), 1 3D, 2 3D within a class in float64.
extern "C" int nms_boxes_launch(const float* mins, const float* maxs, const float* scores,
                                const long long* cls, const bool* valid, bool* keep, int b, int k,
                                int mode, int old_type, double thresh, cudaStream_t stream) {
  if (b < 1 || k < 1 || k > kMaxBoxes || (mode == k3DCls && cls == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case k2D: return launch<k2D>(mins, maxs, nullptr, scores, cls, valid, keep, b, k, thresh, old_type, stream);
    case k3D: return launch<k3D>(mins, maxs, nullptr, scores, cls, valid, keep, b, k, thresh, old_type, stream);
    case k3DCls: return launch<k3DCls>(mins, maxs, nullptr, scores, cls, valid, keep, b, k, thresh, old_type, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// iou: (b, k, k) f32, row i the winner i's; scores: (b, k) f32; valid: (b,
// k) bool or null; keep: (b, k) bool, written in full.
extern "C" int nms_matrix_launch(const float* iou, const float* scores, const bool* valid,
                                 bool* keep, int b, int k, float thresh, cudaStream_t stream) {
  if (b < 1 || k < 1 || k > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kMatrix>(nullptr, nullptr, iou, scores, nullptr, valid, keep, b, k, thresh, 0, stream);
}

#ifdef NMS_PHASES
// the stamps of the first b blocks, (b, 5) int64
extern "C" int nms_phases_read(long long* out, int b) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, nms_phase_clock, b * 5 * sizeof(long long)));
}
#endif
