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
// nms_matrix_global_launch), up to kGlobalMaxBoxes boxes, keeps it in device
// memory, in three launches:
//
// a. nms_sort_kernel, a block a scene: the scene's 8-byte keys sorted in
//    shared memory (runs of 8 in registers, then merged by merge path: K
//    log K, where counting each box's larger keys took K^2 compares and
//    22-43 us at (8, 2,048) / (8, 4,096), and a bitonic network over
//    16-byte keys 42-95 us: PERF.md §6); box_at[p], the box at position p,
//    and the valid count nv. In class-aware mode at thresh >= 0 the key
//    leads with a hash of the class: a pair of two classes suppresses
//    nothing (step 3), so greedy NMS over the scene is greedy NMS over each
//    class's boxes in the same order, and the scene is cut into segments,
//    each decided on its own (two classes of one hash share a segment,
//    their pairs 0 all the same). The other modes have one segment, [0,
//    nv). The sort also writes the list of tiles the segments need. (It
//    writes no bounds by position: one SM's gather of them, a scattered
//    sector a cycle, cost more than the tiles gathering their boxes through
//    box_at on every SM: PERF.md §6.)
// b. The bit matrix, mat[scene][word][position], (B, W, 64 W) u64 with W =
//    ceil(K / 64), from the caller's allocator:
//    - box modes, nms_tiles_kernel: a block walks its scene's list of 64 x
//      64 tiles of positions, those on and above the diagonal that lie
//      within one segment's words (75 of 528 a scene at 2,048 boxes of
//      ScanNet's 18 classes), each pair's overlap by the same device
//      functions, float64 class-aware, float32 otherwise;
//    - matrix mode, nms_rows_kernel: a warp a row of the IoU matrix in box
//      order, every byte of it read once in 16-byte loads (the tiles read a
//      4-byte element a 32-byte sector), each element over thresh setting
//      the bit of its column's position in a row of bits in shared memory.
// c. nms_chain_kernel, a block a segment: the rounds a 64-position word at a
//    time, warp 0 alone on the chain (the diagonal scan, then the winners'
//    rows into the next word) with the next word's loads in flight, the
//    other warps folding the previous word's winners into the later words
//    meanwhile; matrix mode's all -inf rule as in step 4; then the keep
//    flags of the segment's boxes (the sort writes those outside `valid`).
//
// Words a segment shares with its neighbours start with the neighbours'
// positions removed, so that they neither win nor suppress; tiles outside
// every segment are never written and never read. The picks are the
// cluster path's and the plain version's.
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

#include <algorithm>
#include <cstdint>
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
// The global path's kernels, a row of kCycleSlots a block (blockIdx.y *
// gridDim.x + blockIdx.x): the sort's thread 0 stamps clock64() at its start
// and after each step (SORT_STAMP); the tiles' thread 0 and the chain's
// threads 0 and 32 sum the cycles of their steps over their tiles and words
// (CYCLES_FROM, CYCLES_ADD), and write the sums at their end
// (CYCLES_WRITE); read back by nms_global_phases_read.
constexpr int kCycleSlots = 8;
__device__ long long nms_global_clock[3][kPhaseBlocks][kCycleSlots];  // sort, tiles, chain
#define GLOBAL_BLOCK (blockIdx.y * gridDim.x + blockIdx.x)
#define SORT_STAMP(n) \
  if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks) nms_global_clock[0][blockIdx.x][n] = clock64()
#define CYCLES_DECL long long cycles[kCycleSlots] = {}, cycles_from = clock64()
#define CYCLES_FROM() cycles_from = clock64()
#define CYCLES_ADD(slot) cycles[slot] += clock64() - cycles_from
#define CYCLES_COUNT(slot) ++cycles[slot]
#define CYCLES_WRITE(kernel, first, last)                                       \
  if (GLOBAL_BLOCK < kPhaseBlocks) {                                             \
    for (int i = first; i <= last; ++i) nms_global_clock[kernel][GLOBAL_BLOCK][i] = cycles[i]; \
  }
#else
#define NMS_STAMP(n)
#define SORT_STAMP(n)
#define CYCLES_DECL
#define CYCLES_FROM()
#define CYCLES_ADD(slot)
#define CYCLES_COUNT(slot)
#define CYCLES_WRITE(kernel, first, last)
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

constexpr int kSortThreads = 1024;
constexpr int kSortRun = 8;  // keys a thread sorts in registers, and places a merge level
constexpr int kLowBits = 14;  // a box's index in its sort key
constexpr unsigned long long kLowMask = (1ull << kLowBits) - 1ull;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;  // a warp's rows of a tile: 64 / kTileWarps
constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kChainThreads = 512;
constexpr int kChainWarps = kChainThreads / 32;  // warp 0 the chain, the others the later words
constexpr int kFoldBatch = 4;  // later words a helper warp holds the rows of, loaded a word ahead
constexpr int kChainBlocksPerSm = 2;  // the rounds' blocks an SM, spread over the scenes' segments
constexpr int kSmemMax = 232448;  // the H100's largest dynamic shared memory a block
// the sort holds a scene's 8-byte keys twice (the merges' source and
// destination) in one block's shared memory, a pad word after every 32 keys
constexpr int kGlobalMaxBoxes = 14016;
constexpr int kGlobalMaxWords = (kGlobalMaxBoxes + 63) / 64;
constexpr int kSortStatic = 256;  // the sort's static shared memory, at most
__host__ __device__ constexpr int sort_slots(int k) { return k + (k >> 5) + 1; }
static_assert(16 * sort_slots(kGlobalMaxBoxes) + kSortStatic <= kSmemMax,
              "the sort's keys fit one block");
static_assert(kGlobalMaxBoxes <= (1 << kLowBits), "a box's index fits its key");
static_assert(kGlobalMaxWords <= kSortThreads, "a thread counts a row word's tiles");
constexpr unsigned long long kSign = 1ull << 63;
constexpr int kSegShift = 46;  // a key's bits from here on: its segment (and the invalid flag)

// The global path's scratch in device memory, byte offsets from its start
struct Scratch {
  long long box_at, pos_of, nv, nseg, seg_start, tile_off, bytes;

  Scratch(int b, int k) {
    const long long words = (k + 63) / 64;
    long long at = 0;
    auto take = [&at](long long n) {
      const long long here = at;
      at += (n + 15) / 16 * 16;
      return here;
    };
    box_at = take(4LL * b * k);  // the box at each position
    pos_of = take(4LL * b * k);  // each box's position (matrix mode)
    nv = take(4LL * b);  // the valid boxes
    nseg = take(4LL * b);  // the segments
    seg_start = take(4LL * b * (k + 1));  // each segment's first position, then nv
    tile_off = take(4LL * b * (words + 1));  // each row word's first tile, then the tiles
    bytes = at;
  }
};

struct SortOut {
  int* box_at;
  int* pos_of;
  int* nv;
  int* nseg;
  int* seg_start;
  int* tile_off;
};

// the exclusive prefix sum of v over the kSortThreads threads of a block,
// and the total; `sums` 32 ints of shared memory; every thread calls it
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kSortThreads / 32 ? sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  total = sums[kSortThreads / 32 - 1];
  const int before = (warp ? sums[warp - 1] : 0) + x - v;
  __syncthreads();  // sums is free again
  return before;
}

// a box's sort key, ascending: a box outside `valid` sets the top bit; at
// class-aware thresh >= 0 bits 46-62 hash its class (the top 17 bits of
// class x 2^64 / phi), so that a class's boxes are contiguous; then the
// complement of order_key's high word (the larger score first, NaN before
// all) and of the index's (`low`, < 2^14), the tie rule. Two classes of one
// hash share a segment: their pairs are 0 in the bit matrix all the same
__device__ __forceinline__ unsigned long long sort_key(float s, int low, bool ok,
                                                       long long cls, bool segments) {
  const unsigned int o = static_cast<unsigned int>(order_key(s, 0) >> 32);
  const unsigned long long h =
      segments && ok ? (static_cast<unsigned long long>(cls) * 0x9E3779B97F4A7C15ull) >> 47 : 0ull;
  return (ok ? 0ull : kSign) | h << kSegShift | static_cast<unsigned long long>(~o) << kLowBits |
         (kLowMask - static_cast<unsigned long long>(low));
}

// the sum of v over the kSortThreads threads of a block; every thread
// calls it
__device__ __forceinline__ int block_sum(int v, int* sums) {
  int total;
  block_scan(v, sums, total);
  return total;
}

// key i's slot in the sort's shared memory: a pad word after every 32, so
// that the threads' runs, kSortRun keys apart, fall on different banks
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// (a) a block a scene: each box's sort_key, sorted ascending in shared
// memory: each thread sorts a run of kSortRun keys in registers (a bitonic
// network), then the runs are merged pairwise, each thread placing
// kSortRun keys of the merged run after a binary search for its start (the
// merge path), one barrier a level. Then box_at (and pos_of in matrix
// mode), nv, the keep flag false of every box outside `valid`, the
// segments (a class hash's positions at class-aware thresh >= 0, else [0,
// nv)) and, for the tiles, each row word's tiles: the column words from it
// to the end of the segment of its last valid position.
template <int kMode>
__global__ void __launch_bounds__(kSortThreads, 1)
nms_sort_kernel(const float* __restrict__ scores, const long long* __restrict__ cls,
                const bool* __restrict__ valid, bool* __restrict__ keep_out, SortOut out, int k,
                int words, int segments) {
  constexpr bool kMatrixMode = kMode == kMatrix;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* src = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* dst = src + sort_slots(k);
  __shared__ int sums[32];
  const int scene = blockIdx.x, t = threadIdx.x;
  const long long base = static_cast<long long>(scene) * k;
  SORT_STAMP(0);
  // the keys, coalesced, into shared memory in box order
  int ok_count = 0;
  for (int i = t; i < k; i += kSortThreads) {
    const bool ok = valid == nullptr || valid[base + i];
    dst[slot(i)] = sort_key(scores[base + i], kMatrixMode ? k - 1 - i : i, ok,
                            segments ? cls[base + i] : 0, segments);
    ok_count += ok;
  }
  const int nv = block_sum(ok_count, sums);  // its barriers also publish the keys
  // each run of kSortRun keys sorted in registers (a bitonic network);
  // padding keys (~0) sort last
  for (int d0 = t * kSortRun; d0 < k; d0 += kSortThreads * kSortRun) {
    unsigned long long r[kSortRun];
#pragma unroll
    for (int e = 0; e < kSortRun; ++e) r[e] = d0 + e < k ? dst[slot(d0 + e)] : ~0ull;
#pragma unroll
    for (int size = 2; size <= kSortRun; size <<= 1) {
#pragma unroll
      for (int half = size >> 1; half > 0; half >>= 1) {
#pragma unroll
        for (int m = 0; m < kSortRun / 2; ++m) {
          const int x = m % half, at = m / half * 2 * half;
          const int i = at + x, j = half == size >> 1 ? at + size - 1 - x : i + half;
          const unsigned long long lo = r[i] < r[j] ? r[i] : r[j], hi = r[i] < r[j] ? r[j] : r[i];
          r[i] = lo;
          r[j] = hi;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kSortRun; ++e) {
      if (d0 + e < k) src[slot(d0 + e)] = r[e];
    }
  }
  SORT_STAMP(1);
  // the merges: runs of len into runs of 2 len; a thread places kSortRun
  // keys from the start the merge path gives, one load a key and no branch
  for (int len = kSortRun; len < k; len <<= 1) {
    __syncthreads();
    for (int d0 = t * kSortRun; d0 < k; d0 += kSortThreads * kSortRun) {
      const int at = d0 & ~(2 * len - 1);
      const int a_end = min(at + len, k), b_end = min(at + 2 * len, k);
      const int la = a_end - at, lb = b_end - a_end, d = d0 - at;
      int i = max(0, d - lb), top = min(d, la);  // keys of a among the first d
      while (i < top) {
        const int mid = (i + top) >> 1;
        if (src[slot(at + mid)] < src[slot(a_end + d - 1 - mid)]) {
          i = mid + 1;
        } else {
          top = mid;
        }
      }
      int j = d - i;
      unsigned long long va = i < la ? src[slot(at + i)] : ~0ull;
      unsigned long long vb = j < lb ? src[slot(a_end + j)] : ~0ull;
#pragma unroll
      for (int e = 0; e < kSortRun; ++e) {
        const bool take_a = va < vb;
        if (d0 + e < b_end) dst[slot(d0 + e)] = take_a ? va : vb;
        i += take_a;
        j += !take_a;
        const bool more = take_a ? i < la : j < lb;
        const unsigned long long next = more ? src[slot(take_a ? at + i : a_end + j)] : ~0ull;
        va = take_a ? next : va;
        vb = take_a ? vb : next;
      }
    }
    unsigned long long* tmp = src;
    src = dst;
    dst = tmp;
  }
  __syncthreads();
  SORT_STAMP(2);
  // the positions
  for (int p = t; p < k; p += kSortThreads) {
    const int low = static_cast<int>(kLowMask - (src[slot(p)] & kLowMask));
    const int box = kMatrixMode ? k - 1 - low : low;
    out.box_at[base + p] = box;
    if constexpr (kMatrixMode) out.pos_of[base + box] = p;
    if (p >= nv) keep_out[base + box] = false;
  }
  SORT_STAMP(3);
  // the segments: a thread's run of positions, its heads counted, then placed
  auto seg_of = [&](int p) { return src[slot(p)] >> kSegShift; };
  auto head = [&](int p) { return p == 0 || seg_of(p) != seg_of(p - 1); };
  const int run = (nv + kSortThreads - 1) / kSortThreads;
  const int p0 = min(t * run, nv), p1 = min(p0 + run, nv);
  int heads = 0;
  for (int p = p0; p < p1; ++p) heads += head(p);
  int nseg;
  int at = block_scan(heads, sums, nseg);
  int* seg = out.seg_start + static_cast<long long>(scene) * (k + 1);
  for (int p = p0; p < p1; ++p) {
    if (head(p)) seg[at++] = p;
  }
  if (t == 0) {
    seg[nseg] = nv;
    out.nseg[scene] = nseg;
    out.nv[scene] = nv;
  }
  SORT_STAMP(4);
  if constexpr (!kMatrixMode) {
    const int wn = (nv + 63) / 64;
    int count = 0;
    if (t < wn) {
      const int last = min(64 * t + 63, nv - 1);
      const unsigned long long mine = seg_of(last);
      int a = last + 1, b = nv;  // the end of last's segment: the first later head
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (seg_of(mid) == mine) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      count = (a - 1) / 64 - t + 1;
    }
    int total;
    const int first = block_scan(count, sums, total);
    int* tiles = out.tile_off + static_cast<long long>(scene) * (words + 1);
    if (t < wn) tiles[t] = first;
    if (t == 0) tiles[wn] = total;
  }
  SORT_STAMP(5);
}

// (b) box modes: a block walks its scene's tiles (row word rw, column word
// cw) from the sort's list (staged in shared memory), gridDim.x blocks a
// scene. The tile's 64 row and 64 column boxes come through box_at (a
// scattered read of each box's bounds, on every SM); each pair's overlap by
// the cluster path's device functions, float64 class-aware, float32
// otherwise. Only the live pairs (later positions below nv; at class-aware
// thresh >= 0 of one class, whose gate is 1: the others stay 0) are queued,
// a warp's over its 8 rows, 32 at a time, a lane a pair; at thresh >= 0
// only the pairs whose bounds overlap on every axis (an exact float32 test:
// elsewhere a side is 0, or NaN, so the intersection is 0 or NaN and the
// pair sets no bit). Their bits by atomicOr; the tile's 64 row words
// written coalesced into mat[scene][cw][position]. A box with a NaN bound
// takes the NaN-carrying min and max within its tiles: a pair's overlap
// depends on its own two boxes only, so this equals the scene-wide rule.
template <int kMode>
__global__ void __launch_bounds__(kTileThreads)
nms_tiles_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
                 const long long* __restrict__ cls, const int* __restrict__ box_at,
                 const int* __restrict__ nv_in, const int* __restrict__ tile_off,
                 unsigned long long* __restrict__ mat, int k, int words, double thresh,
                 int old_type) {
  using T = typename Traits<kMode>::T;
  constexpr int kAxes = Traits<kMode>::kAxes;
  constexpr int kSlots = 128;  // the tile's 64 row boxes, then its 64 column boxes
  const int scene = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(scene) * k;
  const int nv = nv_in[scene], wn = (nv + 63) / 64;
  CYCLES_DECL;
  __shared__ float lo[kAxes * kSlots], hi[kAxes * kSlots];
  __shared__ T area[kSlots];
  __shared__ long long label[kSlots];
  __shared__ unsigned int bits32[128];  // the tile's 64 rows, two 32-bit halves each
  __shared__ int queue_s[kTileWarps][64];  // a warp's live pairs, (row << 6 | column)
  __shared__ int tiles[kGlobalMaxWords + 1];
  for (int v = t; v <= wn; v += kTileThreads) {
    tiles[v] = tile_off[static_cast<long long>(scene) * (words + 1) + v];
  }
  __syncthreads();
  CYCLES_ADD(0);  // the tile list staged
  const int ntiles = tiles[wn];
  const bool same_class = Traits<kMode>::kGated && !(thresh < 0.0);
  const bool meeting = !(thresh < 0.0);  // only pairs that intersect can set a bit
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    CYCLES_FROM();
    CYCLES_COUNT(4);
    int rw = 0, top = wn - 1;  // the last row word whose first tile is at most `tile`
    while (rw < top) {
      const int mid = (rw + top + 1) >> 1;
      if (tiles[mid] <= tile) {
        rw = mid;
      } else {
        top = mid - 1;
      }
    }
    const int cw = rw + tile - tiles[rw];
    const int q0 = 64 * rw, c0 = 64 * cw;
    bool has_nan = false;
    if (t < kSlots) {
      const int p = min(t < 64 ? q0 + t : c0 + t - 64, nv - 1);  // a dead slot computes on a live box
      const long long box = base + box_at[base + p];
      T d[kAxes];
#pragma unroll
      for (int a = 0; a < kAxes; ++a) {
        const int axis = kAxes == 2 && a == 1 ? 2 : a;
        const float l = mins[box * 3 + axis], h = maxs[box * 3 + axis];
        lo[a * kSlots + t] = l;
        hi[a * kSlots + t] = h;
        d[a] = sub(static_cast<T>(h), static_cast<T>(l));
        has_nan = has_nan || d[a] != d[a];
      }
      T ar = mul(d[0], d[1]);
      if constexpr (kAxes == 3) ar = mul(ar, d[2]);
      area[t] = ar;
      if constexpr (Traits<kMode>::kGated) label[t] = cls[box];
      bits32[t] = 0u;
    }
    const bool any_nan = __syncthreads_or(has_nan);
    CYCLES_ADD(1);  // the boxes loaded
    CYCLES_FROM();
    auto fill = [&](auto nan_tag) {
      constexpr bool kNan = decltype(nan_tag)::value;
      const Boxes<kMode> bx{lo, hi, area, label, kSlots};
      int* queue = queue_s[warp];
      int queued = 0;
      auto test = [&](bool live) {  // every lane, a dead one on the first pair
        const int pr = queue[live ? lane : 0];
        const int r = pr >> 6, cc = pr & 63;
        bool over;
        if (Traits<kMode>::kGated && same_class) {
          over = suppresses<kMode, kNan, true>(bx, r, 64 + cc, old_type, thresh);
        } else {
          over = suppresses<kMode, kNan>(bx, r, 64 + cc, old_type, thresh);
        }
        if (live && over) atomicOr(&bits32[2 * r + (cc >> 5)], 1u << (cc & 31));
      };
      for (int r = warp; r < 64; r += kTileWarps) {
        const int q = q0 + r;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int cc = 32 * g + lane, c = c0 + cc;
          // & and |, not && and ||: every load issued at once, no branch
          bool live = (q < nv) & (c > q) & (c < nv);
          if constexpr (Traits<kMode>::kGated) live &= !same_class | (label[r] == label[64 + cc]);
          if (meeting) {
#pragma unroll
            for (int a = 0; a < kAxes; ++a) {
              live &= (hi[a * kSlots + r] > lo[a * kSlots + 64 + cc]) &
                      (hi[a * kSlots + 64 + cc] > lo[a * kSlots + r]);
            }
          }
          const unsigned int m = __ballot_sync(kFull, live);
          if (live) queue[queued + __popc(m & ((1u << lane) - 1u))] = r << 6 | cc;
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
    };
    if (any_nan) {
      fill(std::true_type{});
    } else {
      fill(std::false_type{});
    }
    CYCLES_ADD(2);  // warp 0's overlaps
    CYCLES_FROM();
    __syncthreads();
    CYCLES_ADD(3);  // waiting for the other warps'
    if (t < 64) {
      const long long at = (static_cast<long long>(scene) * words + cw) * (64LL * words) + q0 + t;
      mat[at] = static_cast<unsigned long long>(bits32[2 * t + 1]) << 32 | bits32[2 * t];
    }
    __syncthreads();  // the next tile's boxes
  }
  if (t == 0) {
    CYCLES_WRITE(1, 0, 4);
  }
}

// the rows kernel's dynamic shared memory: every box's position, then a
// row of `words` words a warp
__host__ __device__ inline int rows_smem(int k, int words) {
  return (4 * k + 15) / 16 * 16 + kRowsWarps * words * 8;
}

// (b) matrix mode: a warp a row of the IoU matrix, rows_per_block rows a
// block, in box order, so that each byte of the matrix is read once, in
// 16-byte loads, streamed (evict-first) past the L2: each element over
// thresh sets, in the warp's row of bits in shared memory, the bit of its
// column's position when that lies after the row's (pos_of through shared
// memory); the row's words from its position's on are written as row
// pos(row) of mat[scene][word][position]. Rows of boxes outside `valid` are
// not read.
__global__ void __launch_bounds__(kRowsThreads)
nms_rows_kernel(const float* __restrict__ iou, const int* __restrict__ pos_of,
                const int* __restrict__ nv_in, unsigned long long* __restrict__ mat, int k,
                int words, int rows_per_block, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* pos = reinterpret_cast<int*>(smem);
  const int scene = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(scene) * k;
  const int nv = nv_in[scene], wn = (nv + 63) / 64;
  const int first = blockIdx.x * rows_per_block, last = min(k, first + rows_per_block);
  unsigned long long* row = reinterpret_cast<unsigned long long*>(smem + (4 * k + 15) / 16 * 16) +
                            warp * words;
  unsigned int* row32 = reinterpret_cast<unsigned int*>(row);
  for (int i = t; i < k; i += kRowsThreads) pos[i] = pos_of[base + i];
  __syncthreads();
  for (int i = first + warp; i < last; i += kRowsWarps) {
    const int p = pos[i];
    if (p >= nv) continue;  // warp-uniform
    const int v0 = p >> 6;
    for (int v = v0 + lane; v < wn; v += 32) row[v] = 0ull;
    __syncwarp();
    // the row from the 16-byte boundary at or before it: the loads' other
    // elements are masked, and an aligned 16 bytes never crosses a page
    const float* src = iou + (base + i) * k;
    const float4* src4 =
        reinterpret_cast<const float4*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15));
    const int off = static_cast<int>(src - reinterpret_cast<const float*>(src4));
    const int n4 = (off + k + 3) >> 2;
    for (int c0 = lane; c0 < n4; c0 += 4 * 32) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // four loads in flight a lane
        const int c = c0 + 32 * u;
        x[u] = c < n4 ? __ldcs(src4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float e[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int j = 4 * (c0 + 32 * u) + h - off;
          if (e[h] > thresh && j >= 0 && j < k) {
            const int pj = pos[j];
            if (pj > p && pj < nv) atomicOr(&row32[pj >> 5], 1u << (pj & 31));
          }
        }
      }
    }
    __syncwarp();
    for (int v = v0 + lane; v < wn; v += 32) {
      mat[(static_cast<long long>(scene) * words + v) * (64LL * words) + p] = row[v];
    }
    __syncwarp();
  }
}

// a word's winners from its diagonal block in shared memory: a position
// not yet removed when the scan reaches it wins, and its row joins the
// mask. A row's bits lie past its position, so a winner is only ever
// removed before its turn, and only winners whose rows hold a bit (`nz`)
// change the mask: the scan visits those alone, in order, a step each
// (each row masked to its later positions), and the winners are the
// positions the mask never took
__device__ __forceinline__ unsigned long long scan_word(const unsigned long long* diag,
                                                        unsigned long long removed,
                                                        unsigned long long nz) {
  unsigned long long visit = ~removed & nz;
  while (visit) {
    const int b = __ffsll(static_cast<long long>(visit)) - 1;
    const unsigned long long later = ~1ull << b;
    removed |= diag[b] & later;
    visit = ~removed & nz & later;
  }
  return ~removed;
}

// the rows of `mine`'s positions (lane and lane + 32 of a word's 64) ORed
// over the warp, a warp reduction a half: every lane gets the sum
__device__ __forceinline__ unsigned long long or_rows(unsigned long long mine, int lane,
                                                      unsigned long long r0,
                                                      unsigned long long r1) {
  const unsigned long long acc =
      (mine >> lane & 1ull ? r0 : 0ull) | (mine >> (lane + 32) & 1ull ? r1 : 0ull);
  const unsigned int hi = __reduce_or_sync(kFull, static_cast<unsigned int>(acc >> 32));
  return static_cast<unsigned long long>(hi) << 32 |
         __reduce_or_sync(kFull, static_cast<unsigned int>(acc));
}

// (c) the rounds of each segment [s0, s1), gridDim.x blocks a scene each
// taking every gridDim.x-th segment, then its keep flags. Positions of the
// segment's first and last words outside it start removed, so that they
// neither win nor suppress (a pair of two segments is 0 anyway). For word w
// warp 0 keeps the chain: lane 0 scans the diagonal block, and the warp ORs
// the winners' rows into word w + 1 (kept in a register for its scan) from
// registers loaded during the last word, while it loads word w + 1's
// diagonal block and the next word of its rows; the other warps fold word
// w - 1's winners into the words after w + 1 meanwhile, a warp per word,
// the rows of its first kFoldBatch words loaded during the word before; one
// barrier a word. Matrix mode's all -inf rule after the scan, as step 4
// applies it (a single segment, [0, nv)).
template <bool kMatrixMode>
__global__ void __launch_bounds__(kChainThreads)
nms_chain_kernel(const float* __restrict__ scores, const int* __restrict__ box_at,
                 const int* __restrict__ nv_in, const int* __restrict__ nseg_in,
                 const int* __restrict__ seg_start, const unsigned long long* __restrict__ mat,
                 bool* __restrict__ keep_out, int k, int words) {
  __shared__ unsigned long long removed[kGlobalMaxWords], won[kGlobalMaxWords];
  __shared__ unsigned long long ninf[kMatrixMode ? kGlobalMaxWords : 1];  // the -inf positions
  __shared__ unsigned long long diag[64];
  __shared__ long long first_s;
  const int scene = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(scene) * k;
  const long long stride = 64LL * words;  // a word's rows
  const unsigned long long* mat_s = mat + static_cast<long long>(scene) * words * stride;
  const int nv = nv_in[scene], nseg = nseg_in[scene];
  const int* seg = seg_start + static_cast<long long>(scene) * (k + 1);
  CYCLES_DECL;
  for (int s = blockIdx.x; s < nseg; s += gridDim.x) {
    const int s0 = seg[s], s1 = seg[s + 1];
    const int a = s0 >> 6, z = (s1 - 1) >> 6, nw = z - a + 1;
    CYCLES_COUNT(6);
    for (int v = t; v < nw; v += kChainThreads) {
      const int e = s1 - 64 * (a + v);  // the segment's positions of the word: [.., e)
      removed[v] = (v == 0 ? (1ull << (s0 & 63)) - 1ull : 0ull) |
                   (e < 64 ? ~((1ull << e) - 1ull) : 0ull);
    }
    if constexpr (kMatrixMode) {  // the -inf positions, and the first valid box's (pf)
      for (int g = warp; g * 32 < nv; g += kChainWarps) {
        const int q = g * 32 + lane;
        const bool neg = q < nv &&
            static_cast<unsigned int>(order_key(scores[base + box_at[base + q]], 0) >> 32) ==
                kNegInfHigh;
        const unsigned int bits = __ballot_sync(kFull, neg);
        if (lane == 0) reinterpret_cast<unsigned int*>(ninf)[g] = bits;
      }
      long long first = static_cast<long long>(k) * k;  // (box, position), packed
      for (int p = t; p < nv; p += kChainThreads) {
        first = min(first, static_cast<long long>(box_at[base + p]) * k + p);
      }
      for (int off = 16; off; off >>= 1) first = min(first, __shfl_xor_sync(kFull, first, off));
      if (t == 0) first_s = static_cast<long long>(k) * k;
      __syncthreads();
      if (lane == 0) atomicMin(&first_s, first);
    }
    const int helpers = kChainWarps - 1;
    // a helper's rows of word w_rows at its words v_first + u helpers
    unsigned long long h0[kFoldBatch], h1[kFoldBatch];
    auto helper_rows = [&](int w_rows, int v_first) {
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u) {
        const int v = v_first + u * helpers;
        const unsigned long long* rows = mat_s + v * stride + 64 * w_rows;
        h0[u] = v <= z ? rows[lane] : 0ull;
        h1[u] = v <= z ? rows[lane + 32] : 0ull;
      }
    };
    unsigned long long d0 = 0ull, d1 = 0ull, n0 = 0ull, n1 = 0ull;  // warp 0's loads for word a
    if (warp == 0) {
      const unsigned long long* rows = mat_s + a * stride + 64 * a;
      d0 = rows[lane];
      d1 = rows[lane + 32];
      if (a < z) {
        n0 = rows[stride + lane];
        n1 = rows[stride + lane + 32];
      }
    } else {
      helper_rows(a, a + 1 + warp);
    }
    __syncthreads();
    unsigned long long carry = 0ull;  // warp 0: the last word's winners' rows in this word
    for (int w = a; w <= z; ++w) {
      CYCLES_FROM();
      CYCLES_COUNT(4);
      if (warp == 0) {
        diag[lane] = d0;
        diag[lane + 32] = d1;
        const unsigned long long nz =
            static_cast<unsigned long long>(__ballot_sync(kFull, d1 != 0ull)) << 32 |
            __ballot_sync(kFull, d0 != 0ull);
        const unsigned long long next0 = n0, next1 = n1;
        if (w < z) {  // word w + 1's loads, in flight during this word
          const unsigned long long* rows = mat_s + (w + 1) * stride + 64 * (w + 1);
          d0 = rows[lane];
          d1 = rows[lane + 32];
          if (w + 1 < z) {
            n0 = rows[stride + lane];
            n1 = rows[stride + lane + 32];
          }
        }
        __syncwarp();
        CYCLES_ADD(0);  // the diagonal block's loads
        CYCLES_FROM();
        unsigned long long mine = lane == 0 ? scan_word(diag, removed[w - a] | carry, nz) : 0ull;
        mine = __shfl_sync(kFull, mine, 0);
        CYCLES_ADD(1);  // the scan
        CYCLES_FROM();
        if (w < z) carry = or_rows(mine, lane, next0, next1);
        if (lane == 0) won[w - a] = mine;
        CYCLES_ADD(2);  // the next word's fold
      } else {
        if (w > a) {  // word w - 1's winners into the words after w + 1
          const unsigned long long prev = won[w - 1 - a];
#pragma unroll
          for (int u = 0; u < kFoldBatch; ++u) {  // the rows loaded during the last word
            // a word has one writer a step (warp 0 keeps its own in a register)
            const int v = w + warp + u * helpers;
            const unsigned long long acc = or_rows(prev, lane, h0[u], h1[u]);
            if (lane == 0 && v <= z) removed[v - a] |= acc;
          }
          for (int v = w + warp + kFoldBatch * helpers; v <= z; v += helpers) {  // past them
            const unsigned long long* rows = mat_s + v * stride + 64 * (w - 1);
            const unsigned long long acc = or_rows(prev, lane, rows[lane], rows[lane + 32]);
            if (lane == 0) removed[v - a] |= acc;
          }
        }
        if (w < z) helper_rows(w, w + 1 + warp);  // for the next word
        CYCLES_ADD(5);  // a helper's folds
      }
      CYCLES_FROM();
      __syncthreads();
      CYCLES_ADD(3);  // the barrier
    }
    if constexpr (kMatrixMode) {
      // _nms_jax's all -inf rule, as step 4 applies it: the segment is [0, nv)
      if (t == 0) {
        const int pf = static_cast<int>(first_s % k);
        bool stuck = false;
        for (int w = 0; w < nw; ++w) {
          unsigned long long hit = won[w] & ninf[w];
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
    for (int p = s0 + t; p < s1; p += kChainThreads) {
      keep_out[base + box_at[base + p]] = won[(p >> 6) - a] >> (p & 63) & 1ull;
    }
    __syncthreads();  // the next segment's masks
  }
  if (t == 0) {
    CYCLES_WRITE(2, 0, 4);
    CYCLES_WRITE(2, 6, 6);
  } else if (t == 32) {
    CYCLES_WRITE(2, 5, 5);
  }
}

// whether the global path can launch b scenes of k boxes
bool bad_global_shape(int b, int k) { return b < 1 || b > 65535 || k < 1 || k > kGlobalMaxBoxes; }

template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kMode>
int launch_global(const float* mins, const float* maxs, const float* iou, const float* scores,
                  const long long* cls, const bool* valid, bool* keep, unsigned char* scratch,
                  unsigned long long* mat, int b, int k, double thresh, int old_type, int blocks,
                  cudaStream_t stream) {
  constexpr bool kMatrixMode = kMode == kMatrix;
  static bool ready = false;  // the attributes once a process, at the largest sizes
  if (!ready) {
    cudaError_t e = allow_smem(nms_sort_kernel<kMode>, 16 * sort_slots(kGlobalMaxBoxes));
    if (e == cudaSuccess && kMatrixMode) {
      e = allow_smem(nms_rows_kernel, rows_smem(kGlobalMaxBoxes, kGlobalMaxWords));
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  if (blocks < 1 || blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (k + 63) / 64;
  const Scratch lay(b, k);
  SortOut out{reinterpret_cast<int*>(scratch + lay.box_at),
              reinterpret_cast<int*>(scratch + lay.pos_of),
              reinterpret_cast<int*>(scratch + lay.nv), reinterpret_cast<int*>(scratch + lay.nseg),
              reinterpret_cast<int*>(scratch + lay.seg_start),
              reinterpret_cast<int*>(scratch + lay.tile_off)};
  const int segments = Traits<kMode>::kGated && !(thresh < 0.0);
  int chain_blocks = 1;  // the class segments': one wave of rounds blocks over the scenes
  if (segments) {
    int device = 0, n_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    chain_blocks = std::max(1, std::min(65535, (n_sm * kChainBlocksPerSm + b - 1) / b));
  }
  nms_sort_kernel<kMode><<<b, kSortThreads, 16 * sort_slots(k), stream>>>(
      scores, cls, valid, keep, out, k, words, segments);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kMatrixMode) {  // blocks: rows a block
    nms_rows_kernel<<<dim3((k + blocks - 1) / blocks, b), kRowsThreads, rows_smem(k, words),
                      stream>>>(iou, out.pos_of, out.nv, mat, k, words, blocks,
                                static_cast<float>(thresh));
  } else {  // blocks: tile blocks a scene
    nms_tiles_kernel<kMode><<<dim3(blocks, b), kTileThreads, 0, stream>>>(
        mins, maxs, cls, out.box_at, out.nv, out.tile_off, mat, k, words, thresh, old_type);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_chain_kernel<kMatrixMode><<<dim3(chain_blocks, b), kChainThreads, 0, stream>>>(
      scores, out.box_at, out.nv, out.nseg, out.seg_start, mat, keep, k, words);
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

// Past kMaxBoxes, up to kGlobalMaxBoxes: the same masks through the global
// matrix. scratch: nms_global_scratch_bytes(b, k) bytes; mat: (b, W, 64 W)
// u64, W = ceil(k / 64); neither is read before it is written here. Box
// mode's other arguments are nms_boxes_launch's, with tile_blocks the tile
// kernel's blocks a scene; matrix mode's nms_matrix_launch's, with
// rows_per_block the rows kernel's matrix rows a block. The rounds take
// kChainBlocksPerSm blocks an SM over the scenes where class-aware mode at
// thresh >= 0 cuts them into class segments, else one a scene.
extern "C" int nms_global_scratch_bytes(int b, int k, long long* bytes) {
  if (bad_global_shape(b, k)) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = Scratch(b, k).bytes;
  return 0;
}

extern "C" int nms_boxes_global_launch(const float* mins, const float* maxs, const float* scores,
                                       const long long* cls, const bool* valid, bool* keep,
                                       unsigned char* scratch, unsigned long long* mat, int b,
                                       int k, int mode, int old_type, double thresh,
                                       int tile_blocks, cudaStream_t stream) {
  if (bad_global_shape(b, k) || (mode == k3DCls && cls == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case k2D: return launch_global<k2D>(mins, maxs, nullptr, scores, cls, valid, keep, scratch, mat, b, k, thresh, old_type, tile_blocks, stream);
    case k3D: return launch_global<k3D>(mins, maxs, nullptr, scores, cls, valid, keep, scratch, mat, b, k, thresh, old_type, tile_blocks, stream);
    case k3DCls: return launch_global<k3DCls>(mins, maxs, nullptr, scores, cls, valid, keep, scratch, mat, b, k, thresh, old_type, tile_blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int nms_matrix_global_launch(const float* iou, const float* scores, const bool* valid,
                                        bool* keep, unsigned char* scratch,
                                        unsigned long long* mat, int b, int k, float thresh,
                                        int rows_per_block, cudaStream_t stream) {
  if (bad_global_shape(b, k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_global<kMatrix>(nullptr, nullptr, iou, scores, nullptr, valid, keep, scratch, mat,
                                b, k, thresh, 0, rows_per_block, stream);
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

// the global path's (sort, tiles, chain) x kPhaseBlocks x kCycleSlots
// stamps and sums, zeroed by nms_global_phases_clear
extern "C" int nms_global_phases_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, nms_global_clock, sizeof(nms_global_clock)));
}

extern "C" int nms_global_phases_clear() {
  static long long zeros[3][kPhaseBlocks][kCycleSlots];
  return static_cast<int>(cudaMemcpyToSymbol(nms_global_clock, zeros, sizeof(zeros)));
}
#endif

