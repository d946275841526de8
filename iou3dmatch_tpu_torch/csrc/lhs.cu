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
// card's instruction rate), but the chain of rounds, each waiting on the
// last. So the whole loop runs in one launch, and a round is kept short.
//
// Each round picks the winner, the remaining box that goes first in the
// round order: a NaN score first (the plain version's argmax takes NaN as
// the largest), the higher index among NaN; then the higher score, ties to
// the higher index (JAX's argmax over the reversed scores). It suppresses
// the remaining boxes whose class-gated IoU with the winner exceeds the
// threshold, and keeps back each suppressed box that fewer than half the
// cluster's size rank above (a higher score, or an equal one at a higher
// index: nms.py:143-145; a NaN score ranks above nothing and nothing ranks
// above it). Once every remaining box scores -inf, the plain version's
// winner is the last box, remaining or not (the last maximum of scores
// masked to -inf); a round with a winner that no longer remains changes
// nothing the next time, so the loop ends after it. The rounds stop once no
// box remains, where JAX's gated rounds change nothing more.
//
// Two paths, chosen by K in lhs_launch:
//
// - K <= 64 (the SSL step's K = 64, unlabeled.MAX_NUM_OBJ): a block of
//   kSmallWarps warps a scene, in three steps with a block barrier between
//   them and none inside the rounds. (1) Order once: kSortThreads threads
//   a box count the boxes that go before it in the round order (K compares
//   of one 64-bit key, order_key, summed by shuffles); the count is its
//   position, and the box is written to that slot in shared memory. (2)
//   The suppression matrix: warp w fills the rows of positions w,
//   w + kSmallWarps, ..., lane l the columns l and l + 32, each a
//   class-gated IoU over the threshold, two ballots a row: one 64-bit mask
//   a position. (3) The rounds, on one warp, in one scan over the
//   positions, unrolled and without a branch, over 64-bit masks that are
//   the same in every lane: a position not yet removed when the scan
//   reaches it is the round's winner (every earlier one is gone), and its
//   cluster is its row less the removed positions. Each lane notes the
//   cluster of each of its two positions; after the scan, a suppressed
//   box's rank is a popcount of its cluster's boxes before it that do not
//   score NaN. So the chain from one round to the next is a few logic
//   operations on constants, not a bit search, loads and branches. A first
//   design, a warp a scene that computed each round's IoUs itself, took
//   35.5 us at (8, 64): one warp waits on every load, division and ballot
//   of every round (PERF.md).
// - K > 64, up to 1,024: a block a scene, a thread a box. Each round takes
//   a block argmax in the round order (warp shuffles, one pass over the
//   warps' winners); each remaining box computes its entry of the winner's
//   IoU row, __syncthreads_count gives the cluster's size, and each
//   suppressed box counts the cluster boxes that rank above it in a loop
//   over shared memory. The JAX function fills the K x K IoU matrix first;
//   here shared memory stays O(K), so every K up to 1,024 fits.
//
// Exactness against JAX and the plain PyTorch version
// (geometry/nms.py::lhs_3d_samecls_plain): the area is (dx dy) dz + 1e-8
// with dx = max(hi - lo, 0), the intersection (ix iy) iz, the IoU
// inter / ((area_i + area_j) - inter), each product, sum and quotient
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; the file
// is built with -fmad=false, see ops/_build.py), and the class gate
// multiplies, so a box of another class has IoU 0 and is compared as such.
// An empty intersection's IoU is 0 (0 over a sum of areas of at least
// 2e-8), so the division runs only where the intersection is not 0 and the
// classes match: a zero dividend sends __fdiv_rn down its slow path.
#include <cuda_runtime.h>
#include <math_constants.h>

#ifdef LHS_PHASES
// Built so by chip_smoke.py --lhs-phases: thread 0 of each block of the
// small path stamps clock64() at its start and after each step, read back
// by lhs_phases_read. The kernels' own build leaves the stamps out.
__device__ long long lhs_phase_clock[4096][6];
#define LHS_STAMP(n) \
  if (threadIdx.x == 0 && blockIdx.x < 4096) lhs_phase_clock[blockIdx.x][n] = clock64()
#else
#define LHS_STAMP(n)
#endif

namespace {

constexpr int kMaxBoxes = 1024;
constexpr int kSmallBoxes = 64;  // up to this K: a block a scene, 64-bit masks
constexpr int kSmallWarps = 16;  // the warps that fill the suppression matrix
constexpr int kSortThreads = 8;  // threads that find a box's position
static_assert(kSmallBoxes * kSortThreads <= 32 * kSmallWarps, "a sort thread for each share");

__device__ __forceinline__ float clamp0(float x) { return x > 0.f ? x : 0.f; }

__device__ __forceinline__ float prod3(float x, float y, float z) {
  return __fmul_rn(__fmul_rn(x, y), z);
}

// (score, index) a goes before (score, index) b in the round order: NaN
// first, the higher index among NaN; then a higher score, or an equal one at
// a higher index
__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  const bool na = isnan(sa), nb = isnan(sb);
  if (na || nb) return na && (!nb || ia > ib);
  return sa > sb || (sa == sb && ia > ib);
}

// the round order as one unsigned compare: order_key(sa, ia) > order_key(sb,
// ib) exactly when beats(sa, ia, sb, ib). The score's bits are mapped to an
// order-keeping unsigned int, -0 taken as +0 and every NaN above +inf.
__device__ __forceinline__ unsigned long long order_key(float s, int i) {
  const unsigned int u = __float_as_uint(s == 0.f ? 0.f : s);
  const unsigned int o = isnan(s) ? 0xffffffffu : (u & 0x80000000u ? ~u : u | 0x80000000u);
  return static_cast<unsigned long long>(o) << 32 | static_cast<unsigned int>(i);
}

__device__ __forceinline__ float box_area(const float* lo, const float* hi) {
  return __fadd_rn(prod3(clamp0(__fsub_rn(hi[0], lo[0])), clamp0(__fsub_rn(hi[1], lo[1])),
                         clamp0(__fsub_rn(hi[2], lo[2]))), 1e-8f);
}

// whether box (lo, hi, area, label) is suppressed by the winner
__device__ __forceinline__ bool overlaps(const float* wlo, const float* whi, float warea,
                                         long long wlabel, const float* lo, const float* hi,
                                         float area, long long label, float thresh) {
  float side[3];
  for (int c = 0; c < 3; ++c) side[c] = clamp0(__fsub_rn(fminf(whi[c], hi[c]), fmaxf(wlo[c], lo[c])));
  const float inter = prod3(side[0], side[1], side[2]);
  const float iou = wlabel == label && inter != 0.f
                        ? __fdiv_rn(inter, __fsub_rn(__fadd_rn(warea, area), inter)) : 0.f;
  return iou > thresh;
}

__device__ __forceinline__ unsigned long long ballot64(bool lo_half, bool hi_half) {
  return static_cast<unsigned long long>(__ballot_sync(0xffffffffu, lo_half))
         | static_cast<unsigned long long>(__ballot_sync(0xffffffffu, hi_half)) << 32;
}

__global__ void __launch_bounds__(32 * kSmallWarps)
lhs_small_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
                 const float* __restrict__ scores, const long long* __restrict__ cls,
                 bool* __restrict__ keep_out, int k, float thresh) {
  // by box index (key_of), then by position in the round order
  __shared__ unsigned long long key_of[kSmallBoxes];
  __shared__ float lo[kSmallBoxes][3];
  __shared__ float hi[kSmallBoxes][3];
  __shared__ float area[kSmallBoxes];
  __shared__ float score[kSmallBoxes];
  __shared__ long long label[kSmallBoxes];
  __shared__ int box_at[kSmallBoxes];
  __shared__ unsigned long long row_of[kSmallBoxes];  // positions it suppresses
  __shared__ int last_at;                              // the position of box k - 1

  LHS_STAMP(0);
  // (1) order once: kSortThreads threads a box, each counting over its
  // share of the boxes, summed by shuffles
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i = t / kSortThreads, part = t % kSortThreads;
  const bool box = i < k;
  const long long base = static_cast<long long>(blockIdx.x) * k;
  const long long at = base + (box ? i : 0);
  const float s = scores[at];
  float blo[3], bhi[3];
  for (int c = 0; c < 3; ++c) {
    blo[c] = mins[at * 3 + c];
    bhi[c] = maxs[at * 3 + c];
  }
  const long long bl = cls[at];
  const unsigned long long key = order_key(s, i);
  if (box && part == 0) key_of[i] = key;
  __syncthreads();
  LHS_STAMP(1);
  int p = 0;
  for (int j = part; j < k; j += kSortThreads) p += key_of[j] > key;
  for (int off = kSortThreads / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
  if (box && part == 0) {
    for (int c = 0; c < 3; ++c) {
      lo[p][c] = blo[c];
      hi[p][c] = bhi[c];
    }
    area[p] = box_area(blo, bhi);
    score[p] = s;
    label[p] = bl;
    box_at[p] = i;
    if (i == k - 1) last_at = p;
  }
  __syncthreads();
  LHS_STAMP(2);

  // (2) the suppression matrix, by position
  float my_lo[2][3], my_hi[2][3], my_area[2];
  long long my_label[2];
  for (int h = 0; h < 2; ++h) {
    const int q = h * 32 + lane < k ? h * 32 + lane : 0;
    for (int c = 0; c < 3; ++c) {
      my_lo[h][c] = lo[q][c];
      my_hi[h][c] = hi[q][c];
    }
    my_area[h] = area[q];
    my_label[h] = label[q];
  }
#pragma unroll
  for (int rr = 0; rr < kSmallBoxes / kSmallWarps; ++rr) {
    const int r = warp + rr * kSmallWarps;
    if (r >= k) break;
    bool over[2];
    for (int h = 0; h < 2; ++h) {
      over[h] = overlaps(lo[r], hi[r], area[r], label[r], my_lo[h], my_hi[h], my_area[h],
                         my_label[h], thresh);
    }
    const unsigned long long row = ballot64(over[0], over[1]);
    if (lane == 0) row_of[r] = row;
  }
  __syncthreads();
  LHS_STAMP(3);
  if (warp != 0) return;

  // (3) the rounds: one scan over the positions, unrolled and without a
  // branch, so that each position's bits are constants and the chain from
  // one position to the next is a few logic operations on the removed
  // mask. Each lane notes the cluster that suppresses each of its two
  // positions; which of them are kept back is worked out after the scan.
  bool nan_h[2], ninf_h[2];
  for (int h = 0; h < 2; ++h) {
    const int q = h * 32 + lane;
    const float sq = score[q < k ? q : 0];
    nan_h[h] = q < k && isnan(sq);
    ninf_h[h] = q < k && sq == -CUDART_INF_F;
  }
  const unsigned long long nan_at = ballot64(nan_h[0], nan_h[1]);
  const unsigned long long ninf_at = ballot64(ninf_h[0], ninf_h[1]);
  const int last = last_at;
  unsigned long long removed = k == kSmallBoxes ? 0ull : ~((1ull << k) - 1);  // won or suppressed
  unsigned long long won = 0, mine[2] = {0ull, 0ull};  // mine: the cluster of each of my positions
  bool stuck = false;
#pragma unroll
  for (int q = 0; q < kSmallBoxes; ++q) {
    const unsigned long long bit = 1ull << q;
    // q is the first remaining position: the round's winner, unless every
    // remaining box scores -inf; then the winner is box k - 1 (after the scan)
    const bool first = !(removed & bit) && !stuck;
    stuck = stuck || (first && (ninf_at & bit) && q != last);
    const bool wins = first && !stuck;
    const unsigned long long cluster = wins ? row_of[q] & ~removed & ~bit : 0ull;
    removed |= cluster | (wins ? bit : 0ull);
    won |= wins ? bit : 0ull;
    for (int h = 0; h < 2; ++h) mine[h] = cluster >> (h * 32 + lane) & 1 ? cluster : mine[h];
  }
  if (stuck) {  // box k - 1 wins, whether it remains or not; the rounds after
                // would repeat this one with no cluster
    const unsigned long long cluster = row_of[last] & ~removed & ~(1ull << last);
    won |= 1ull << last;
    for (int h = 0; h < 2; ++h) mine[h] = cluster >> (h * 32 + lane) & 1 ? cluster : mine[h];
  }
  // a suppressed box is kept back when fewer than half its cluster's size
  // rank above it: the cluster's boxes before it that do not score NaN
  bool back[2];
  for (int h = 0; h < 2; ++h) {
    const int q = h * 32 + lane;
    const int rank = nan_h[h] ? 0 : __popcll(mine[h] & ~nan_at & ((1ull << q) - 1));
    back[h] = mine[h] && rank < __popcll(mine[h]) / 2;
  }
  const unsigned long long kept = won | ballot64(back[0], back[1]);
  LHS_STAMP(4);
  for (int h = 0; h < 2; ++h) {
    const int q = h * 32 + lane;
    if (q < k) keep_out[base + box_at[q]] = kept >> q & 1;
  }
  LHS_STAMP(5);
}

__global__ void lhs_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
                           const float* __restrict__ scores, const long long* __restrict__ cls,
                           bool* __restrict__ keep_out, int k, float thresh) {
  extern __shared__ float smem[];
  float* lo = smem;              // [k][3]
  float* hi = lo + 3 * k;        // [k][3]
  float* area = hi + 3 * k;      // [k]
  float* score = area + k;       // [k]
  long long* label = reinterpret_cast<long long*>(score + k);  // [k], 8-byte aligned
  int* supp_of = reinterpret_cast<int*>(label + k);  // [k]
  __shared__ float warp_score[32];
  __shared__ int warp_index[32];
  __shared__ int winner;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const bool box = t < k;
  const long long base = static_cast<long long>(blockIdx.x) * k;
  float my_lo[3] = {0.f, 0.f, 0.f}, my_hi[3] = {0.f, 0.f, 0.f};
  float my_area = 0.f, my_score = -CUDART_INF_F;
  long long my_cls = 0;
  if (box) {
    for (int c = 0; c < 3; ++c) {
      my_lo[c] = mins[(base + t) * 3 + c];
      my_hi[c] = maxs[(base + t) * 3 + c];
      lo[t * 3 + c] = my_lo[c];
      hi[t * 3 + c] = my_hi[c];
    }
    my_area = box_area(my_lo, my_hi);
    my_score = scores[base + t];
    my_cls = cls[base + t];
    area[t] = my_area;
    score[t] = my_score;
    label[t] = my_cls;
  }
  bool remaining = box, keep = false;
  for (int round = 0; round < k; ++round) {
    if (!__syncthreads_or(remaining)) break;  // also orders the last round's reads
    // block argmax of the remaining boxes in the round order; a box that no
    // longer remains scores -inf
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
    const bool supp = remaining && t != w
                      && overlaps(lo + w * 3, hi + w * 3, area[w], label[w], my_lo, my_hi, my_area,
                                  my_cls, thresh);
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

// mins, maxs: (b, k, 3) f32; scores: (b, k) f32; cls: (b, k) int64;
// keep: (b, k) bool, written in full.
extern "C" int lhs_launch(const float* mins, const float* maxs, const float* scores,
                          const long long* cls, bool* keep, int b, int k, float thresh,
                          cudaStream_t stream) {
  if (b < 1 || k < 1 || k > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= kSmallBoxes) {
    lhs_small_kernel<<<b, 32 * kSmallWarps, 0, stream>>>(mins, maxs, scores, cls, keep, k, thresh);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = (k + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(k) * (8 * sizeof(float) + sizeof(long long) + sizeof(int));
  lhs_kernel<<<b, threads, smem, stream>>>(mins, maxs, scores, cls, keep, k, thresh);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LHS_PHASES
// the stamps of the first b blocks, (b, 6) int64
extern "C" int lhs_phases_read(long long* out, int b) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, lhs_phase_clock, b * 6 * sizeof(long long)));
}
#endif
