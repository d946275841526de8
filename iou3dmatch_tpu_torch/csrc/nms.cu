// Greedy non-maximum suppression over each scene's K boxes: a bool keep mask.
//
// Replaces the XLA program iou3dmatch_tpu/geometry/nms.py::_nms_jax
// (nms.py:170-191, behind nms_rotated_jax :194 and nms_normal_jax :205),
// and serves the eval path's three NumPy NMS branches of parse_predictions
// (iou3dmatch_tpu/eval/ap_helper.py:95-135, nms.py:14-107), which the JAX
// package runs on the host, one scene at a time. One launch takes all B
// scenes of a request, a thread-block cluster of C blocks a scene (C <= 16,
// chosen by ops/nms.py::nms_plan), K <= 1,024 boxes. Two entry points share
// one scan:
//
// - box mode (nms_boxes_launch): the cluster computes each pair's overlap
//   from the boxes' camera-frame bounds, as _nms_loop does: 2D over axes x
//   and z (nms_2d_faster), 3D (nms_3d_faster), or 3D gated on equal classes
//   (nms_3d_faster_samecls), the first two in float32 and the class-aware
//   one in float64, as the JAX package's NumPy arrays are there;
// - matrix mode (nms_matrix_launch): the overlap is a given (K, K) float32
//   IoU matrix, compared in float32, as _nms_jax does.
//
// What bounds it on the H100: neither bytes (a few KB a scene in box mode)
// nor operations (K^2 / 2 overlaps, well under a microsecond at the card's
// rates even in float64), but latency: the chain of rounds, each waiting on
// the last, and each overlap's own dependent chain of rounded operations. A
// block a scene (the first design) filled the bit matrix on one SM with 124
// of 132 idle at B = 8, divided in float64 for every pair even where the
// class gate made the overlap 0, and ran the rounds on one thread at about
// 48 cycles a position (PERF.md §6). This design, steps as NMS_STAMP marks
// them:
//
// 1. Load. Every block of a cluster loads all K boxes of its scene into its
//    own shared memory (bounds as float32, by box index) with a 64-bit order
//    key each: NaN scores first, then the higher score, ties (and NaN among
//    themselves) to the higher index in box mode (np.argsort(kind="stable")
//    read from the back, the port's rule, geometry/nms.py), to the lower
//    index in matrix mode (jnp.argmax takes the first maximum, and NaN as
//    the largest). Boxes outside `valid` key below every valid one.
// 2. Order. A box's position counts the larger keys, K compares a box, a
//    few threads a box. Up to kLocalOrder boxes every block counts all of them,
//    with no barrier (a cluster barrier and an exchange cost more than the
//    counting they save, PERF.md §6); past it block r counts its share
//    and every block reads the others' positions through distributed shared
//    memory (DSMEM), after a cluster barrier.
// 3. The bit matrix. Row q (the later positions the winner at q suppresses)
//    is filled by block q % C, warp (q / C) % 16, into a staging row in its
//    shared memory, whose words go to the leader block (rank 0) by DSMEM
//    stores; 1,024 x 1,024 bits is 128 KB in the leader, and a cluster
//    barrier makes it whole. The lanes compute on every column, clamped,
//    and masks drop the dead ones: no branch parts a row's groups.
//    - In class-aware mode at thresh >= 0 a pair of two classes suppresses
//      nothing: its overlap times the gate 0 is 0 or NaN, and neither is >
//      thresh (nor is the 0 of a zero intersection). So a row queues only
//      the later positions of its own class (a ballot a 32-column group, 32
//      queued columns a batch, a lane each) and sets their bits by
//      atomicOr: with ScanNet's 18 classes about one pair in 18. Within a
//      class the gate is 1 (suppresses, kSameClass). At thresh < 0 every
//      pair is computed, as the plain version defines it.
//    - Otherwise a ballot a 32-column group.
// 4. The rounds, in the leader's warp 0, a 64-position word at a time. For
//    word w, lane w decides the word's winners serially from the diagonal
//    64 x 64 block (a position not yet removed when the scan reaches it
//    wins, and its diagonal word joins the mask): a test and a select a
//    position, the loads off the chain. Then the winners' rows go into the
//    later words in parallel (fold_rows): lanes l with l % S == v hold word
//    v's mask, S the words rounded up to a power of two, each ORing the rows
//    of a share of the winners, joined by a butterfly. Matrix mode keeps
//    _nms_jax's rule for an all -inf remainder, after the scan: the -inf
//    positions are the last valid ones, so the scan is exact up to the
//    first of them that wins other than the first valid box; there the
//    masked argmax picks the first valid box, remaining or not, and the
//    rounds after it change nothing.
// 5. The write: the leader writes every box's keep flag.
//
// Past kMaxBoxes the K x K bit matrix no longer fits one block's shared
// memory, and a second path (nms_boxes_global_launch,
// nms_matrix_global_launch) keeps it in device memory, in three launches:
//
// a. nms_order_kernel, a block per (scene, kOrderThreads boxes): a box's
//    position counts the larger keys of its scene (the same order_key, read
//    through shared memory kOrderTile keys at a time); box_at[p] is the box
//    at position p, and each scene's first block writes its count of valid
//    boxes, nv.
// b. nms_tile_kernel, a block per (scene, 64 x 64 tile of positions) on and
//    above the diagonal and below nv: the tile's 64 row and 64 column boxes
//    in shared memory, each pair's overlap by the same device functions,
//    float64 class-aware, float32 otherwise, the class queue at thresh >= 0
//    (a warp's candidate pairs over its 8 rows queued 32 at a time), a
//    ballot a 32-column group otherwise; the tile's 64 row words written
//    coalesced into mat[scene][word][position], (B, W, 64 W) u64 with W =
//    ceil(K / 64) from the caller's allocator. A box with a NaN bound
//    takes the NaN-carrying min and max within its tiles: a pair's overlap
//    depends on its own two boxes only, so this equals the scene-wide rule.
// c. nms_rounds_kernel, a block a scene: for each word w below ceil(nv /
//    64), 64 threads stage its diagonal words, thread 0 decides its winners
//    serially, then a warp per later word ORs the winners' rows into that
//    word of the removed mask (W words in shared memory, kept there whole);
//    matrix mode's all -inf rule as in step 4; then every keep flag.
//
// Rows past nv in the last word are written as zeros, so they remove
// nothing. The picks are the cluster path's and the plain version's.
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
// fmaxf gives the same. Where the intersection is 0 the quotient is 0, or
// NaN when its divisor is 0 or NaN, whichever sign: it exceeds thresh
// exactly when the divisor is neither and 0 > thresh, which is tested
// without dividing (a zero dividend sends __fdiv_rn down its slow path).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace cg = cooperative_groups;

#ifdef NMS_PHASES
// Built so by chip_smoke.py's NMS rows: thread 0 of each block stamps
// clock64() at its start and after each step, and counts the overlaps its
// rows computed and skipped; read back by nms_phases_read. Blocks past the
// leader have no rounds: their last stamps repeat the matrix barrier's. The
// kernel's own build leaves the stamps out.
constexpr int kPhaseBlocks = 4096;
constexpr int kStamps = 9;
__device__ long long nms_phase_clock[kPhaseBlocks][kStamps + 2];  // stamps, computed, skipped
#define NMS_STAMP(n) \
  if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks) nms_phase_clock[blockIdx.x][n] = clock64()
#else
#define NMS_STAMP(n)
#endif

namespace {

constexpr int kMaxBoxes = 1024;
constexpr int kMaxWords = kMaxBoxes / 64;  // 64-bit words a row of the matrix
constexpr int kMaxCluster = 16;
constexpr int kLocalOrder = 128;  // boxes every block orders itself (PERF.md §6)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxWords <= 16, "fold_rows gives each word two lanes at least");

enum Mode { k2D = 0, k3D = 1, k3DCls = 2, kMatrix = 3 };

template <int kMode>
struct Traits {
  using T = typename std::conditional<kMode == k3DCls, double, float>::type;
  static constexpr int kAxes = kMode == k2D ? 2 : 3;  // 2D: axes x and z
  static constexpr bool kBoxes = kMode != kMatrix;
  static constexpr bool kGated = kMode == k3DCls;
};

// The dynamic shared memory of a block, in bytes from its start: every
// block of a launch has the same, though only the leader keeps the matrix.
struct Layout {
  // n bytes at `at`, which moves on to the next 8-byte boundary
  __host__ __device__ static int take(int& at, int n) {
    const int here = at;
    at += (n + 7) / 8 * 8;
    return here;
  }

  int words;  // 64-bit words a row of the matrix: ceil(k / 64)
  int mat, key, label, area, lo, hi, box_at, pos_of, bytes;

  __host__ __device__ Layout(int k, int mode) {
    const bool boxes = mode != kMatrix, gated = mode == k3DCls;
    const int axes = mode == k2D ? 2 : 3, tsize = gated ? 8 : 4;
    words = (k + 63) / 64;
    int at = 0;
    mat = take(at, 64 * words * words * 8);  // rows rounded up to whole words
    key = take(at, k * 8);
    label = take(at, gated ? k * 8 : 0);
    area = take(at, boxes ? k * tsize : 0);
    lo = take(at, boxes ? axes * k * 4 : 0);
    hi = take(at, boxes ? axes * k * 4 : 0);
    box_at = take(at, k * 4);
    pos_of = take(at, k * 4);
    bytes = at;
  }
};

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

// The boxes of a scene in a block's shared memory, by box index: float32
// bounds axis by axis (lo[a * k + i]), the area in the mode's type.
template <int kMode>
struct Boxes {
  using T = typename Traits<kMode>::T;
  const float* lo;
  const float* hi;
  const T* area;
  const long long* label;
  int k;
};

// whether the winner box r suppresses box c, in _nms_loop's order of
// operations; kNan: some bound of the scene is NaN, so min and max carry NaN
// as np.minimum and np.maximum do; kSameClass: r and c are of one class, so
// the class gate is 1 and o * 1 is o
template <int kMode, bool kNan, bool kSameClass = false>
__device__ __forceinline__ bool suppresses(const Boxes<kMode>& bx, int r, int c, int old_type,
                                           double thresh) {
  using T = typename Traits<kMode>::T;
  constexpr int kAxes = Traits<kMode>::kAxes;
  T side[kAxes];
#pragma unroll
  for (int a = 0; a < kAxes; ++a) {
    const T hr = bx.hi[a * bx.k + r], hc = bx.hi[a * bx.k + c];
    const T lr = bx.lo[a * bx.k + r], lc = bx.lo[a * bx.k + c];
    side[a] = kNan ? clamp0(sub(nan_min(hr, hc), nan_max(lr, lc)))
                   : fast_max(sub(fast_min(hr, hc), fast_max(lr, lc)), T(0));
  }
  T inter = mul(side[0], side[1]);
  if constexpr (kAxes == 3) inter = mul(inter, side[2]);
  const T den = old_type ? bx.area[c] : sub(add(bx.area[r], bx.area[c]), inter);
  // a zero intersection is decided without dividing (a zero dividend sends
  // the division down its slow path): the quotient is 0, or NaN where den is
  // 0 or NaN. Selects, not branches, so that a row's groups do not diverge
  const bool zero = inter == T(0);
  const bool by_zero = den != T(0) && den == den && T(0) > static_cast<T>(thresh);
  T o = quo(zero ? T(1) : inter, zero ? T(1) : den);
  if constexpr (Traits<kMode>::kGated && !kSameClass) {
    o = mul(o, bx.label[r] == bx.label[c] ? T(1) : T(0));
  }
  return zero ? by_zero : o > static_cast<T>(thresh);
}

// the pick order as one unsigned compare: a larger key goes first. The
// score's bits map to an order-keeping unsigned int, -0 taken as +0 and every
// NaN above +inf; `low` breaks ties. Its high word is kNegInfHigh or more.
__device__ __forceinline__ unsigned long long order_key(float s, int low) {
  const unsigned int u = __float_as_uint(s == 0.f ? 0.f : s);
  const unsigned int o = isnan(s) ? 0xffffffffu : (u & 0x80000000u ? ~u : u | 0x80000000u);
  return static_cast<unsigned long long>(o) << 32 | static_cast<unsigned int>(low);
}

constexpr unsigned int kNegInfHigh = 0x007fffffu;  // order_key's high word of -inf
// a box outside `valid`, or'd with its `low`: below every order_key
constexpr unsigned long long kInvalidKey = 1ull << 32;

// The rows of word w's winners (`mine`) ORed into word (lane & (S - 1)) of
// the removed mask: S >= the scene's words, so that 32 / S lanes share each
// word, each ORing the rows of 64 S / 32 winners, then a butterfly joins them.
template <int S>
__device__ __forceinline__ unsigned long long fold_rows(const unsigned long long* mat, int words,
                                                       int w, unsigned long long mine, int lane) {
  constexpr int kParts = 32 / S, kBits = 64 / kParts;
  const int v = min(lane & (S - 1), words - 1), part = lane / S;
  const unsigned long long bits = mine >> (part * kBits);
  const unsigned long long* rows = mat + static_cast<long long>(64 * w + part * kBits) * words + v;
  unsigned long long acc[4] = {0ull, 0ull, 0ull, 0ull};  // four chains, not one
#pragma unroll
  for (int b = 0; b < kBits; ++b) acc[b & 3] |= rows[b * words] & (0ull - (bits >> b & 1ull));
  unsigned long long all = (acc[0] | acc[1]) | (acc[2] | acc[3]);
#pragma unroll
  for (int off = S; off < 32; off <<= 1) all |= __shfl_xor_sync(kFull, all, off);
  return all;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
           const float* __restrict__ iou, const float* __restrict__ scores,
           const long long* __restrict__ cls, const bool* __restrict__ valid,
           bool* __restrict__ keep_out, int k, double thresh, int old_type) {
  using T = typename Traits<kMode>::T;
  constexpr int kAxes = Traits<kMode>::kAxes;
  constexpr bool kBoxes = Traits<kMode>::kBoxes;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int scene = blockIdx.x / csize;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(scene) * k;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(k, kMode);
  unsigned long long* mat = reinterpret_cast<unsigned long long*>(smem + lay.mat);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + lay.key);
  long long* label = reinterpret_cast<long long*>(smem + lay.label);
  T* area = reinterpret_cast<T*>(smem + lay.area);
  float* lo = reinterpret_cast<float*>(smem + lay.lo);
  float* hi = reinterpret_cast<float*>(smem + lay.hi);
  int* box_at = reinterpret_cast<int*>(smem + lay.box_at);
  int* pos_of = reinterpret_cast<int*>(smem + lay.pos_of);
  const int words = lay.words;
  __shared__ unsigned long long stage[kWarps][kMaxWords];  // a warp's row being filled
  __shared__ int queue_s[kWarps][64];  // class-aware: a warp's candidate columns
  __shared__ unsigned long long won[kMaxWords];
  __shared__ unsigned long long ninf[kMaxWords];  // matrix mode: positions scoring -inf
#ifdef NMS_PHASES
  __shared__ unsigned long long n_computed, n_skipped;
  if (t == 0) n_computed = n_skipped = 0;
#endif

  NMS_STAMP(0);
  // (1) load: every box of the scene, by index
  bool has_nan = false;
  int n_ok = 0;
  for (int i = t; i < k; i += kThreads) {
    const bool ok = valid == nullptr || valid[base + i];
    const int low = kMode == kMatrix ? k - 1 - i : i;
    key[i] = ok ? order_key(scores[base + i], low) : kInvalidKey | static_cast<unsigned int>(low);
    n_ok += ok;
    if constexpr (kBoxes) {
      T d[kAxes];
#pragma unroll
      for (int a = 0; a < kAxes; ++a) {
        const int axis = kAxes == 2 && a == 1 ? 2 : a;
        const float l = mins[(base + i) * 3 + axis], h = maxs[(base + i) * 3 + axis];
        lo[a * k + i] = l;
        hi[a * k + i] = h;
        d[a] = sub(static_cast<T>(h), static_cast<T>(l));
        has_nan = has_nan || (ok && d[a] != d[a]);  // a NaN bound, or inf - inf
      }
      T ar = mul(d[0], d[1]);
      if constexpr (kAxes == 3) ar = mul(ar, d[2]);
      area[i] = ar;
      if constexpr (Traits<kMode>::kGated) label[i] = cls[base + i];
    }
  }
  static_assert(kMaxBoxes <= 2 * kThreads, "a thread loads at most two boxes");
  const int nv = __syncthreads_count(n_ok >= 1) + __syncthreads_count(n_ok >= 2);  // valid boxes
  const bool any_nan = __syncthreads_or(has_nan);
  // the class queue only where a pair of two classes can decide nothing
  const bool skip = Traits<kMode>::kGated && !(thresh < 0.0);
  NMS_STAMP(1);

  // (2) the order, box_at[p] the box at position p: up to kLocalOrder boxes
  // every block counts for all of them, with no barrier; past it block r
  // counts for its share, and every block reads the others' positions from
  // their owners through DSMEM. Boxes outside `valid` come last, in
  // positions nv..k - 1.
  const bool local = k <= kLocalOrder;
  const int share = local ? k : (k + csize - 1) / csize;
  const int first = local ? 0 : rank * share;
  const int cnt = max(0, min(share, k - first));
  int tpb = 1;  // threads a box: a power of two up to a warp
  while (tpb < 32 && tpb * 2 * cnt <= kThreads) tpb *= 2;
  for (int pass = 0; pass < cnt; pass += kThreads / tpb) {
    const int local_i = pass + t / tpb, part = t % tpb;
    const int i = first + min(local_i, cnt - 1);
    const unsigned long long ki = key[i];
    int p = 0;
#pragma unroll 8
    for (int j = part; j < k; j += tpb) p += key[j] > ki;
    for (int off = tpb / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
    if (local_i < cnt && part == 0) {
      if (local) {
        box_at[p] = i;
      } else {
        pos_of[i] = p;
      }
    }
  }
  NMS_STAMP(2);
  if (local) {
    __syncthreads();
    NMS_STAMP(3);
  } else {
    cluster.sync();  // every share is ordered
    NMS_STAMP(3);
    for (int i = t; i < k; i += kThreads) {  // a warp's 32 boxes one coalesced load
      const int owner = i / share;
      box_at[owner == rank ? pos_of[i] : *cluster.map_shared_rank(&pos_of[i], owner)] = i;
    }
    __syncthreads();
  }
  NMS_STAMP(4);

  // (3) the bit matrix: this block's rows q (q % C == rank), into the
  // leader's matrix
  if constexpr (kMode == kMatrix) {
    if (rank == 0) {  // the -inf positions, for the rounds
      for (int g = warp; g * 32 < nv; g += kWarps) {
        const int q = g * 32 + lane;
        const bool neg = q < nv && static_cast<unsigned int>(key[box_at[q]] >> 32) == kNegInfHigh;
        const unsigned int bits = __ballot_sync(kFull, neg);
        if (lane == 0) reinterpret_cast<unsigned int*>(ninf)[g] = bits;
      }
    }
  }
  const int wn = (nv + 63) / 64;  // words that hold positions < nv
  // kNan: a constant in each copy, so that no branch parts a row's groups
  auto fill_rows = [&](auto nan_tag) {
    constexpr bool kNan = decltype(nan_tag)::value;
    const Boxes<kMode> bx{lo, hi, area, label, k};
    unsigned long long* leader_mat = cluster.map_shared_rank(mat, 0);
    unsigned long long* row = stage[warp];
    unsigned int* row32 = reinterpret_cast<unsigned int*>(row);
    int* queue = queue_s[warp];
    const float thresh_f = static_cast<float>(thresh);
    for (int q = (warp * csize) + rank; q < nv; q += kWarps * csize) {
      const int v0 = q >> 6;
      if (lane < wn - v0) row[v0 + lane] = 0ull;
      __syncwarp();
      const int r = box_at[q];
      // every lane computes, a dead one on box r itself, and the mask drops
      // it: no branch around the arithmetic
      if (skip) {
        // the later positions of q's class, queued 32 at a time so that
        // each overlap runs on a lane of its own; their bits by atomicOr
        const long long lq = label[r];
        int queued = 0, found = 0;
        auto test = [&](bool live) {
          const int c = live ? queue[lane] : q;
          const bool over = suppresses<kMode, kNan, true>(bx, r, box_at[c], old_type, thresh);
          if (live && over) atomicOr(&row32[c >> 5], 1u << (c & 31));
        };
#pragma unroll 4
        for (int c0 = (q + 1) & ~31; c0 < nv; c0 += 32) {
          const int c = c0 + lane;
          const bool cand = (c > q) & (c < nv) & (label[box_at[min(c, k - 1)]] == lq);
          const unsigned int m = __ballot_sync(kFull, cand);
          if (cand) queue[queued + __popc(m & ((1u << lane) - 1u))] = c;
          queued += __popc(m);
          found += __popc(m);
          if (queued >= 32) {
            __syncwarp();
            test(true);
            __syncwarp();
            queued -= 32;
            if (lane < queued) queue[lane] = queue[32 + lane];
            __syncwarp();
          }
        }
        __syncwarp();
        if (queued > 0) test(lane < queued);
#ifdef NMS_PHASES
        if (lane == 0) {
          atomicAdd(&n_computed, static_cast<unsigned long long>(found));
          atomicAdd(&n_skipped, static_cast<unsigned long long>(nv - 1 - q - found));
        }
#endif
      } else {  // every later position: a ballot a 32-column group
#pragma unroll 4
        for (int c0 = (q + 1) & ~31; c0 < nv; c0 += 32) {
          const int c = c0 + lane;
          const bool live = (c > q) & (c < nv);
          const int cb = box_at[live ? c : q];
          bool over;
          if constexpr (kMode == kMatrix) {
            over = iou[(base + r) * k + cb] > thresh_f;
          } else {
            over = suppresses<kMode, kNan>(bx, r, cb, old_type, thresh);
          }
          const unsigned int bits = __ballot_sync(kFull, live && over);
          if (lane == 0) row32[c0 >> 5] = bits;
        }
#ifdef NMS_PHASES
        if (lane == 0) atomicAdd(&n_computed, static_cast<unsigned long long>(nv - 1 - q));
#endif
      }
      __syncwarp();
      if (lane < wn - v0) leader_mat[q * words + v0 + lane] = row[v0 + lane];
      __syncwarp();
    }
  };
  if (kMode != kMatrix && any_nan) {
    fill_rows(std::true_type{});
  } else {
    fill_rows(std::false_type{});
  }
  NMS_STAMP(5);
  cluster.sync();  // the leader's matrix is whole; no block reads another's memory after this
  NMS_STAMP(6);
#ifdef NMS_PHASES
  if (t == 0 && blockIdx.x < kPhaseBlocks) {
    nms_phase_clock[blockIdx.x][kStamps] = static_cast<long long>(n_computed);
    nms_phase_clock[blockIdx.x][kStamps + 1] = static_cast<long long>(n_skipped);
  }
#endif
  if (rank != 0) {
    NMS_STAMP(7);
    NMS_STAMP(8);
    return;
  }

  // (4) the rounds, in warp 0: a position not yet removed when the scan
  // reaches it wins.
  if (warp == 0) {
    // lanes l with l % S == v hold the removed mask of word v
    const int S = wn <= 2 ? 2 : wn <= 4 ? 4 : wn <= 8 ? 8 : 16;
    int pf = 0;  // matrix mode: the position of the first valid box
    if constexpr (kMode == kMatrix) {
      int first = kMaxBoxes * kMaxBoxes;  // (box, position) of the lowest box, packed
      for (int p = lane; p < nv; p += 32) first = min(first, box_at[p] * kMaxBoxes + p);
      pf = __reduce_min_sync(kFull, first) % kMaxBoxes;
    }
    unsigned int rm_lo = 0u, rm_hi = 0u;  // the removed mask of word lane % S, in halves
    for (int w = 0; w < wn; ++w) {
      // lane w decides word w's winners serially from the diagonal block
      unsigned int mine_lo = 0u, mine_hi = 0u;
      if (lane == w) {
        const unsigned long long* diag = mat + static_cast<long long>(64 * w) * words + w;
        // rows past nv (the last word only) are read and may "win", but
        // their bits lie past nv, where no one reads
#pragma unroll
        for (int b = 0; b < 64; ++b) {
          // a constant position: its half and bit. The loads and ors do not
          // wait on the chain, which is one test and a select a position
          const unsigned long long d = diag[b * words];
          const unsigned int bit = 1u << (b & 31);
          const bool wins = ((b < 32 ? rm_lo : rm_hi) & bit) == 0u;
          const unsigned int lo = rm_lo | static_cast<unsigned int>(d);
          const unsigned int hi = rm_hi | static_cast<unsigned int>(d >> 32);
          rm_lo = wins ? lo : rm_lo;
          rm_hi = wins ? hi : rm_hi;
          if (b < 32) {
            mine_lo |= wins ? bit : 0u;
          } else {
            mine_hi |= wins ? bit : 0u;
          }
        }
      }
      mine_lo = __shfl_sync(kFull, mine_lo, w);
      mine_hi = __shfl_sync(kFull, mine_hi, w);
      if (w + 1 < wn) {  // the winners' rows into the later words
        const unsigned long long mine = static_cast<unsigned long long>(mine_hi) << 32 | mine_lo;
        unsigned long long acc;
        switch (S) {
          case 2: acc = fold_rows<2>(mat, words, w, mine, lane); break;
          case 4: acc = fold_rows<4>(mat, words, w, mine, lane); break;
          case 8: acc = fold_rows<8>(mat, words, w, mine, lane); break;
          default: acc = fold_rows<16>(mat, words, w, mine, lane); break;
        }
        if ((lane & (S - 1)) > w) {
          rm_lo |= static_cast<unsigned int>(acc);
          rm_hi |= static_cast<unsigned int>(acc >> 32);
        }
      }
      if (lane == 0) won[w] = static_cast<unsigned long long>(mine_hi) << 32 | mine_lo;
    }
    if constexpr (kMode == kMatrix) {
      // _nms_jax's all -inf rule, off the scan's chain: the -inf positions
      // are the last valid ones, so the scan above is exact up to the first
      // of them that wins other than the first valid box (pf); there every
      // remaining box scores -inf, the masked argmax picks pf, remaining or
      // not, and no later round changes anything
      if (lane == 0) {
        bool stuck = false;
        for (int w = 0; w < wn; ++w) {
          const int len = min(64, nv - 64 * w);
          unsigned long long hit = won[w] & ninf[w] & (len == 64 ? ~0ull : (1ull << len) - 1ull);
          if (pf >> 6 == w) hit &= ~(1ull << (pf & 63));
          if (stuck) {
            won[w] = 0ull;
          } else if (hit) {
            won[w] &= (hit & (0ull - hit)) - 1ull;  // the positions before it
            stuck = true;
          }
        }
        if (stuck) won[pf >> 6] |= 1ull << (pf & 63);
      }
    }
  }
  __syncthreads();
  NMS_STAMP(7);
  for (int p = t; p < k; p += kThreads) {
    keep_out[base + box_at[p]] = p < nv && (won[p >> 6] >> (p & 63) & 1ull);
  }
  NMS_STAMP(8);
}

template <int kMode>
cudaError_t config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int blocks, int cluster,
                   int k, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(nms_kernel<kMode>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(nms_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout(kMaxBoxes, kMode).bytes);
    }
    if (e != cudaSuccess) return e;
    ready = true;
  }
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout(k, kMode).bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int kMode>
int launch(const float* mins, const float* maxs, const float* iou, const float* scores,
           const long long* cls, const bool* valid, bool* keep, int b, int k, double thresh,
           int old_type, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = config<kMode>(cfg, attr, b * cluster, cluster, k, stream);
  if (e == cudaSuccess) {
    e = cudaLaunchKernelEx(&cfg, nms_kernel<kMode>, mins, maxs, iou, scores, cls, valid, keep, k,
                           thresh, old_type);
  }
  return e != cudaSuccess ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

template <int kMode>
int max_active(int k, int cluster, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = config<kMode>(cfg, attr, cluster, cluster, k, nullptr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(count, nms_kernel<kMode>, &cfg);
  return static_cast<int>(e);
}

bool bad_shape(int b, int k) { return b < 1 || k < 1 || k > kMaxBoxes; }

// ------------------------------------------------- past kMaxBoxes: the global matrix

constexpr int kOrderThreads = 256;  // boxes an order block places
constexpr int kOrderTile = 2048;  // keys an order block stages in shared memory at a time
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;  // a warp's rows of a tile: 64 / kTileWarps
constexpr int kRoundsThreads = 512;
constexpr int kRoundsWarps = kRoundsThreads / 32;
constexpr int kSmemMax = 232448;  // the H100's largest dynamic shared memory a block

// the order key of box i, as nms_kernel's load computes it
__device__ __forceinline__ unsigned long long box_key(const float* scores, const bool* valid,
                                                      long long base, int i, int k, bool matrix) {
  const bool ok = valid == nullptr || valid[base + i];
  const int low = matrix ? k - 1 - i : i;
  return ok ? order_key(scores[base + i], low) : kInvalidKey | static_cast<unsigned int>(low);
}

// (a) box_at[p] = the box at position p; nv[scene] = the valid boxes
__global__ void __launch_bounds__(kOrderThreads)
nms_order_kernel(const float* __restrict__ scores, const bool* __restrict__ valid,
                 int* __restrict__ box_at, int* __restrict__ nv_out, int k, int matrix) {
  __shared__ unsigned long long keys[kOrderTile];
  __shared__ int n_ok;
  const int scene = blockIdx.y, t = threadIdx.x;
  const long long base = static_cast<long long>(scene) * k;
  const int i = blockIdx.x * kOrderThreads + t;
  const unsigned long long mine = i < k ? box_key(scores, valid, base, i, k, matrix) : 0ull;
  int pos = 0;
  for (int j0 = 0; j0 < k; j0 += kOrderTile) {
    const int len = min(kOrderTile, k - j0);
    for (int j = t; j < len; j += kOrderThreads) keys[j] = box_key(scores, valid, base, j0 + j, k, matrix);
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < len; ++j) pos += keys[j] > mine;
    __syncthreads();
  }
  if (i < k) box_at[base + pos] = i;
  if (blockIdx.x == 0) {  // the scene's valid boxes, by its first block
    if (t == 0) n_ok = 0;
    __syncthreads();
    int ok = 0;
    for (int j = t; j < k; j += kOrderThreads) ok += valid == nullptr || valid[base + j];
    atomicAdd(&n_ok, ok);
    __syncthreads();
    if (t == 0) nv_out[scene] = n_ok;
  }
}

// (b) the 64 x 64 tile (row word rw, column word cw) of a scene's matrix
template <int kMode>
__global__ void __launch_bounds__(kTileThreads)
nms_tile_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
                const float* __restrict__ iou, const long long* __restrict__ cls,
                const int* __restrict__ box_at, const int* __restrict__ nv_in,
                unsigned long long* __restrict__ mat, int k, int words, double thresh,
                int old_type) {
  using T = typename Traits<kMode>::T;
  constexpr int kAxes = Traits<kMode>::kAxes;
  constexpr int kSlots = 128;  // the tile's 64 row boxes, then its 64 column boxes
  const int scene = blockIdx.y;
  const int rw = blockIdx.x / words, cw = blockIdx.x % words;
  const int nv = nv_in[scene];
  const int q0 = 64 * rw, c0 = 64 * cw;
  if (cw < rw || q0 >= nv || c0 >= nv) return;  // block-uniform: no tile the rounds read
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(scene) * k;
  __shared__ float lo[kAxes * kSlots], hi[kAxes * kSlots];
  __shared__ T area[kSlots];
  __shared__ long long label[kSlots];
  __shared__ int box[kSlots];
  __shared__ unsigned int bits32[128];  // the tile's 64 rows, two 32-bit halves each
  __shared__ int queue_s[kTileWarps][64];
  bool has_nan = false;
  if (t < kSlots) {
    const int p = t < 64 ? q0 + t : c0 + t - 64;
    const int r = box_at[base + min(p, nv - 1)];  // a dead slot computes on a live box
    box[t] = r;
    if constexpr (Traits<kMode>::kBoxes) {
      T d[kAxes];
#pragma unroll
      for (int a = 0; a < kAxes; ++a) {
        const int axis = kAxes == 2 && a == 1 ? 2 : a;
        const float l = mins[(base + r) * 3 + axis], h = maxs[(base + r) * 3 + axis];
        lo[a * kSlots + t] = l;
        hi[a * kSlots + t] = h;
        d[a] = sub(static_cast<T>(h), static_cast<T>(l));
        has_nan = has_nan || (p < nv && d[a] != d[a]);
      }
      T ar = mul(d[0], d[1]);
      if constexpr (kAxes == 3) ar = mul(ar, d[2]);
      area[t] = ar;
      if constexpr (Traits<kMode>::kGated) label[t] = cls[base + r];
    }
  }
  if (t < 128) bits32[t] = 0u;
  const bool any_nan = __syncthreads_or(has_nan);
  const bool skip = Traits<kMode>::kGated && !(thresh < 0.0);
  const float thresh_f = static_cast<float>(thresh);
  auto fill = [&](auto nan_tag) {
    constexpr bool kNan = decltype(nan_tag)::value;
    const Boxes<kMode> bx{lo, hi, area, label, kSlots};
    if (skip) {
      // same-class pairs only, queued (row << 6 | column) 32 at a time, a lane
      // a pair; their bits by atomicOr
      int* queue = queue_s[warp];
      int queued = 0;
      auto test = [&](bool live) {
        const int pr = queue[live ? lane : 0];
        const int r = pr >> 6, cc = pr & 63;
        const bool over = suppresses<kMode, kNan, true>(bx, r, 64 + cc, old_type, thresh);
        if (live && over) atomicOr(&bits32[2 * r + (cc >> 5)], 1u << (cc & 31));
      };
      for (int r = warp; r < 64; r += kTileWarps) {
        const int q = q0 + r;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int cc = 32 * g + lane, c = c0 + cc;
          const bool cand = (q < nv) & (c > q) & (c < nv) & (label[r] == label[64 + cc]);
          const unsigned int m = __ballot_sync(kFull, cand);
          if (cand) queue[queued + __popc(m & ((1u << lane) - 1u))] = r << 6 | cc;
          queued += __popc(m);
          if (queued >= 32) {
            __syncwarp();
            test(true);
            __syncwarp();
            queued -= 32;
            if (lane < queued) queue[lane] = queue[32 + lane];
            __syncwarp();
          }
        }
      }
      __syncwarp();
      if (queued > 0) test(lane < queued);
    } else {  // every pair: a ballot a 32-column group
      for (int r = warp; r < 64; r += kTileWarps) {
        const int q = q0 + r;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int cc = 32 * g + lane, c = c0 + cc;
          const bool live = (q < nv) & (c > q) & (c < nv);
          bool over;
          if constexpr (kMode == kMatrix) {
            over = iou[(base + box[r]) * k + box[64 + cc]] > thresh_f;
          } else {
            over = suppresses<kMode, kNan>(bx, r, 64 + cc, old_type, thresh);
          }
          const unsigned int bits = __ballot_sync(kFull, live && over);
          if (lane == 0) bits32[2 * r + g] = bits;
        }
      }
    }
  };
  if (kMode != kMatrix && any_nan) {
    fill(std::true_type{});
  } else {
    fill(std::false_type{});
  }
  __syncthreads();
  if (t < 64) {
    const long long at = (static_cast<long long>(scene) * words + cw) * (64LL * words) + q0 + t;
    mat[at] = static_cast<unsigned long long>(bits32[2 * t + 1]) << 32 | bits32[2 * t];
  }
}

// the rounds kernel's shared memory, all of it dynamic: matrix mode's first
// valid box, a diagonal block, and the removed, won and -inf masks of `words`
// words
__host__ __device__ inline long long rounds_smem(int words) { return 8 + 64 * 8 + 3LL * words * 8; }

// (c) the rounds of a scene, then its keep flags
template <bool kMatrixMode>
__global__ void __launch_bounds__(kRoundsThreads)
nms_rounds_kernel(const float* __restrict__ scores, const int* __restrict__ box_at,
                  const int* __restrict__ nv_in, const unsigned long long* __restrict__ mat,
                  bool* __restrict__ keep_out, int k, int words) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long& first_s = *reinterpret_cast<long long*>(smem);
  unsigned long long* diag = reinterpret_cast<unsigned long long*>(smem) + 1;
  unsigned long long* removed = diag + 64;
  unsigned long long* won = removed + words;
  unsigned long long* ninf = won + words;
  const int scene = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(scene) * k;
  const unsigned long long* mat_s = mat + static_cast<long long>(scene) * words * (64LL * words);
  const int nv = nv_in[scene];
  const int wn = (nv + 63) / 64;
  for (int v = t; v < wn; v += kRoundsThreads) removed[v] = 0ull;
  if constexpr (kMatrixMode) {
    // the -inf positions, and the position of the first valid box (pf)
    for (int g = warp; g * 32 < nv; g += kRoundsWarps) {
      const int q = g * 32 + lane;
      const bool neg = q < nv &&
          static_cast<unsigned int>(order_key(scores[base + box_at[base + q]], 0) >> 32) ==
              kNegInfHigh;
      const unsigned int bits = __ballot_sync(kFull, neg);
      if (lane == 0) reinterpret_cast<unsigned int*>(ninf)[g] = bits;
    }
    long long first = static_cast<long long>(k) * k;  // (box, position), packed
    for (int p = t; p < nv; p += kRoundsThreads) {
      first = min(first, static_cast<long long>(box_at[base + p]) * k + p);
    }
    for (int off = 16; off; off >>= 1) first = min(first, __shfl_xor_sync(kFull, first, off));
    if (t == 0) first_s = static_cast<long long>(k) * k;
    __syncthreads();
    if (lane == 0) atomicMin(&first_s, first);
  }
  __syncthreads();
  for (int w = 0; w < wn; ++w) {
    const unsigned long long* word_w = mat_s + static_cast<long long>(w) * (64LL * words);
    if (t < 64) diag[t] = word_w[64 * w + t];
    __syncthreads();
    if (t == 0) {  // a position not yet removed when the scan reaches it wins
      unsigned long long rem = removed[w], mine = 0ull;
#pragma unroll
      for (int b = 0; b < 64; ++b) {
        const bool wins = (rem >> b & 1ull) == 0ull;
        rem |= wins ? diag[b] : 0ull;
        mine |= wins ? 1ull << b : 0ull;
      }
      removed[w] = rem;
      won[w] = mine;
    }
    __syncthreads();
    const unsigned long long mine = won[w];
    for (int v = w + 1 + warp; v < wn; v += kRoundsWarps) {  // the winners' rows into word v
      const unsigned long long* word_v = mat_s + static_cast<long long>(v) * (64LL * words) + 64 * w;
      unsigned long long acc = (mine >> lane & 1ull ? word_v[lane] : 0ull) |
                               (mine >> (lane + 32) & 1ull ? word_v[lane + 32] : 0ull);
#pragma unroll
      for (int off = 16; off; off >>= 1) acc |= __shfl_xor_sync(kFull, acc, off);
      if (lane == 0) removed[v] |= acc;
    }
    __syncthreads();
  }
  if constexpr (kMatrixMode) {
    // _nms_jax's all -inf rule, as step 4 applies it
    if (t == 0) {
      const int pf = static_cast<int>(first_s % k);
      bool stuck = false;
      for (int w = 0; w < wn; ++w) {
        const int len = min(64, nv - 64 * w);
        unsigned long long hit = won[w] & ninf[w] & (len == 64 ? ~0ull : (1ull << len) - 1ull);
        if (pf >> 6 == w) hit &= ~(1ull << (pf & 63));
        if (stuck) {
          won[w] = 0ull;
        } else if (hit) {
          won[w] &= (hit & (0ull - hit)) - 1ull;  // the positions before it
          stuck = true;
        }
      }
      if (stuck) won[pf >> 6] |= 1ull << (pf & 63);
    }
    __syncthreads();
  }
  for (int p = t; p < k; p += kRoundsThreads) {
    keep_out[base + box_at[base + p]] = p < nv && (won[p >> 6] >> (p & 63) & 1ull);
  }
}

// whether the global path can launch b scenes of k boxes
bool bad_global_shape(int b, int k) {
  if (b < 1 || b > 65535 || k < 1) return true;
  const long long words = (k + 63LL) / 64;
  return words * words >= (1LL << 31) || rounds_smem(static_cast<int>(words)) > kSmemMax;
}

template <int kMode>
int launch_global(const float* mins, const float* maxs, const float* iou, const float* scores,
                  const long long* cls, const bool* valid, bool* keep, int* scratch,
                  unsigned long long* mat, int b, int k, double thresh, int old_type,
                  cudaStream_t stream) {
  constexpr bool kMatrixMode = kMode == kMatrix;
  const int words = (k + 63) / 64;
  int* box_at = scratch;
  int* nv = scratch + static_cast<long long>(b) * k;
  nms_order_kernel<<<dim3((k + kOrderThreads - 1) / kOrderThreads, b), kOrderThreads, 0, stream>>>(
      scores, valid, box_at, nv, k, kMatrixMode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_tile_kernel<kMode><<<dim3(words * words, b), kTileThreads, 0, stream>>>(
      mins, maxs, iou, cls, box_at, nv, mat, k, words, thresh, old_type);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = static_cast<int>(rounds_smem(words));
  static bool ready = false;  // the attribute once a process, at the largest size
  if (!ready) {
    e = cudaFuncSetAttribute(nms_rounds_kernel<kMatrixMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  nms_rounds_kernel<kMatrixMode><<<b, kRoundsThreads, smem, stream>>>(scores, box_at, nv, mat,
                                                                      keep, k, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mins, maxs: (b, k, 3) f32; scores: (b, k) f32; cls: (b, k) int64 (mode 2
// only, else may be null); valid: (b, k) bool or null; keep: (b, k) bool,
// written in full. mode: 0 2D (x, z), 1 3D, 2 3D within a class in float64.
// A cluster of `cluster` blocks a scene, 1 to 16.
extern "C" int nms_boxes_launch(const float* mins, const float* maxs, const float* scores,
                                const long long* cls, const bool* valid, bool* keep, int b, int k,
                                int mode, int old_type, double thresh, int cluster,
                                cudaStream_t stream) {
  if (bad_shape(b, k) || (mode == k3DCls && cls == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case k2D: return launch<k2D>(mins, maxs, nullptr, scores, cls, valid, keep, b, k, thresh, old_type, cluster, stream);
    case k3D: return launch<k3D>(mins, maxs, nullptr, scores, cls, valid, keep, b, k, thresh, old_type, cluster, stream);
    case k3DCls: return launch<k3DCls>(mins, maxs, nullptr, scores, cls, valid, keep, b, k, thresh, old_type, cluster, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// iou: (b, k, k) f32, row i the winner i's; scores: (b, k) f32; valid: (b,
// k) bool or null; keep: (b, k) bool, written in full.
extern "C" int nms_matrix_launch(const float* iou, const float* scores, const bool* valid,
                                 bool* keep, int b, int k, float thresh, int cluster,
                                 cudaStream_t stream) {
  if (bad_shape(b, k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kMatrix>(nullptr, nullptr, iou, scores, nullptr, valid, keep, b, k, thresh, 0,
                         cluster, stream);
}

// Past kMaxBoxes, any K the card holds: the same masks through the global
// matrix. scratch: b k + b i32 (box_at, nv); mat: (b, W, 64 W) u64, W =
// ceil(k / 64), neither read before it is written here. Box mode's other
// arguments are nms_boxes_launch's; matrix mode's nms_matrix_launch's.
extern "C" int nms_boxes_global_launch(const float* mins, const float* maxs, const float* scores,
                                       const long long* cls, const bool* valid, bool* keep,
                                       int* scratch, unsigned long long* mat, int b, int k,
                                       int mode, int old_type, double thresh,
                                       cudaStream_t stream) {
  if (bad_global_shape(b, k) || (mode == k3DCls && cls == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case k2D: return launch_global<k2D>(mins, maxs, nullptr, scores, cls, valid, keep, scratch, mat, b, k, thresh, old_type, stream);
    case k3D: return launch_global<k3D>(mins, maxs, nullptr, scores, cls, valid, keep, scratch, mat, b, k, thresh, old_type, stream);
    case k3DCls: return launch_global<k3DCls>(mins, maxs, nullptr, scores, cls, valid, keep, scratch, mat, b, k, thresh, old_type, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int nms_matrix_global_launch(const float* iou, const float* scores, const bool* valid,
                                        bool* keep, int* scratch, unsigned long long* mat, int b,
                                        int k, float thresh, cudaStream_t stream) {
  if (bad_global_shape(b, k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_global<kMatrix>(nullptr, nullptr, iou, scores, nullptr, valid, keep, scratch, mat,
                                b, k, thresh, 0, stream);
}

// cudaOccupancyMaxActiveClusters for a launch of `mode` (0-2 box modes, 3
// matrix mode) at k boxes a scene: how many such clusters the card holds at
// once.
extern "C" int nms_max_active_clusters(int mode, int k, int cluster, int* count) {
  if (bad_shape(1, k)) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case k2D: return max_active<k2D>(k, cluster, count);
    case k3D: return max_active<k3D>(k, cluster, count);
    case k3DCls: return max_active<k3DCls>(k, cluster, count);
    case kMatrix: return max_active<kMatrix>(k, cluster, count);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef NMS_PHASES
// each of the first `blocks` blocks' kStamps stamps and its overlaps
// computed and skipped, (blocks, kStamps + 2) int64
extern "C" int nms_phases_read(long long* out, int blocks) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, nms_phase_clock, blocks * (kStamps + 2) * sizeof(long long)));
}
#endif

