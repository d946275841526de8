// Inverse-distance interpolation over three neighbours, feature propagation's
// (FP's) interpolation, and its backward into the features.
//
// Forward: out[b, q, :] = [w0 f[b, i0, :] + w1 f[b, i1, :] + w2 f[b, i2, :] |
// skip[b, q, :]], each index clamped to [0, m - 1]; the skip half (FP's
// unknown_feats, Cs channels) is optional. Replaces the XLA program of
// iou3dmatch_tpu/ops/interpolate.py::three_interpolate (:111, its forward
// _interp_fwd :131), a gather of three rows and a weighted sum, and the
// jnp.concatenate that follows it in iou3dmatch_tpu/models/pointnet2.py:
// 240-241, which XLA fuses with it. FP1 and FP2 run it on every path:
// (B, 256, 256) onto 512 queries and (B, 512, 256) onto 1,024, with 256 skip
// channels, B 8 or 12.
//
// What bounds it on the H100: bytes. Each query's three rows are read (from
// L2 mostly: a scene's table is 256 or 512 KB), its skip row read and its
// output row of C + Cs floats written once: 30 MB at FP2 of 8 scenes, about
// 9 us at 3.35 TB/s; a separate concatenation would read the interpolated
// rows and the skip rows again and write the output again. A block takes
// kTile queries of the flattened b * n: it stages their indices and weights
// in shared memory with one coalesced load, so no row load waits on a
// lane's index load and shuffles; then each warp takes kQueries queries and
// puts all their row and skip loads of a 32-piece step in flight before its
// stores. Lanes move 16-byte pieces (kVec = 4 where C and Cs are multiples
// of 4 and the tables are 16-byte aligned, single floats otherwise).
//
// Backward: grad_f[b, r, :] = sum over the 3 n slots s = 3 q + k whose
// clamped index is r, in ascending s, of g[b, q, :] * w[b, s]. Replaces the
// custom VJP _interp_bwd (:137) -> ops/scatter.py::batched_onehot_segment_sum,
// a one-hot matrix product for the TPU's matrix unit. g is read through its
// strides: FP's cotangent of [interpolated | skip] is (B, n, C + Cs), and the
// features' share is its first C columns, read in place.
//
// What bounds it on the H100: bytes. g (8 MB at FP2 of 8 scenes) is read
// once and the output (4 MB) written once, 3.8 us; a pull scheme reads each
// g row once for each of its three slots, the two others from L2. One
// launch, no global scratch, no float atomics: a block takes (scene, range
// of rows, slice of channels) and, for each window of kWindow slots,
//  1. stages the window's clamped indices, each warp its own contiguous
//     segment with all its loads in flight, keeps the slots that fall in the
//     block's rows, in order, packed as (row, slot) (a ballot and a popcount
//     a step), and counts them (shared-memory integer atomics, native on
//     Hopper, into counts of the warp's own);
//  2. scans the counts into where each row's slots begin, warp by warp, and
//     cuts the rows into runs of about equal work for teams of lanes (a
//     row's write weighing as a slot's add), all in one pass over the rows;
//  3. places each kept slot in its row's list: a warp walks its kept slots
//     32 at a time, ranks equal rows by __match_any_sync, and so each row's
//     list holds its slots in ascending order;
//  4. sums: each team (a lane a 16-byte piece of the slice) walks its run's
//     slots in order with kBatch slots' g pieces and weights in flight, and
//     writes each row once; rows no slot names get zeros. A later window
//     adds to what the earlier one wrote, the same order continued.
// Every block stages its scene's whole window, so the plan
// (ops/interpolate.py::interp_bwd_plan) takes slices of 128 channels (a
// warp's 16-byte loads a row) and as many row ranges as fit one wave of two
// blocks an SM (the registers allow two; a second wave cost more than the
// smaller ranges saved): at FP2 of 8 scenes 16 ranges, a block's 32 rows.
// The sum's reads of each g row once for each of its three slots, 25 MB
// from L2 at FP2 of 8 scenes, and the staging of the window bound it.
// Each row's sum starts from 0 and adds each product, rounded on its own
// (__fmul_rn, __fadd_rn; the file is built with -fmad=false), in ascending
// slot order: the order of the plain version's index_add_ on the CPU, whose
// output it is bit for bit, from run to run.
//
// Exactness of the forward: the plain version (ops/interpolate.py::
// three_interpolate_plain) multiplies each gathered row by its weight and
// sums the three products in order from the sum's identity, ((0 + p0) + p1)
// + p2; each product and sum is rounded on its own here, so the output is
// the plain version's bit for bit, the sign of a zero included; the skip
// rows are copied as they are. Offsets into the tables are 64-bit.
#include <cuda_runtime.h>

namespace {

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
  __device__ static T zero() { return 0.f; }
  __device__ static T mix(T a, T b, T c, float w0, float w1, float w2) {
    return lerp3(a, b, c, w0, w1, w2);
  }
  __device__ static T add_product(T acc, T v, float w) { return __fadd_rn(acc, __fmul_rn(v, w)); }
};
template <>
struct Piece<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T mix(T a, T b, T c, float w0, float w1, float w2) {
    return make_float4(lerp3(a.x, b.x, c.x, w0, w1, w2), lerp3(a.y, b.y, c.y, w0, w1, w2),
                       lerp3(a.z, b.z, c.z, w0, w1, w2), lerp3(a.w, b.w, c.w, w0, w1, w2));
  }
  __device__ static T add_product(T acc, T v, float w) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, w)), __fadd_rn(acc.y, __fmul_rn(v.y, w)),
                       __fadd_rn(acc.z, __fmul_rn(v.z, w)), __fadd_rn(acc.w, __fmul_rn(v.w, w)));
  }
};

// ---------------------------------------------------------------- forward

constexpr int kFwdThreads = 256;
constexpr int kQueries = 2;  // queries a warp
constexpr int kTile = kFwdThreads / 32 * kQueries;  // queries a block

// A block a tile of kTile queries of the flattened b * n; a warp kQueries of
// them, each lane a piece of each query's row at a time.
template <int kVec, bool kSkip>
__global__ void __launch_bounds__(kFwdThreads)
three_interpolate_kernel(const float* __restrict__ f, const int* __restrict__ idx,
                         const float* __restrict__ w, const float* __restrict__ skip,
                         float* __restrict__ out, long long queries, int n, int m, int c, int cs) {
  using T = typename Piece<kVec>::T;
  __shared__ int s_row[3 * kTile];
  __shared__ float s_w[3 * kTile];
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTile;
  const int tq = static_cast<int>(min(static_cast<long long>(kTile), queries - q0));
  for (int i = tid; i < 3 * tq; i += kFwdThreads) {
    s_row[i] = min(max(idx[q0 * 3 + i], 0), m - 1);
    s_w[i] = w[q0 * 3 + i];
  }
  __syncthreads();
  if (warp * kQueries >= tq) return;  // warp-uniform: no query left for this warp

  const int pieces = c / kVec, skip_pieces = kSkip ? cs / kVec : 0;
  const long long width = static_cast<long long>(c) + cs;  // an output row's floats
  const T* rows[kQueries][3];
  const T* skip_row[kQueries];
  T* out_row[kQueries];
  float wt[kQueries][3];
  bool live[kQueries];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int lq = min(warp * kQueries + k, tq - 1);  // a query past the tile repeats the last
    const long long q = q0 + lq;
    const long long table = q / n * m;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rows[k][j] = reinterpret_cast<const T*>(f + (table + s_row[3 * lq + j]) * c);
      wt[k][j] = s_w[3 * lq + j];
    }
    skip_row[k] = kSkip ? reinterpret_cast<const T*>(skip + q * cs) : nullptr;
    out_row[k] = reinterpret_cast<T*>(out + q * width);
    live[k] = warp * kQueries + k < tq;
  }
  const int steps = kSkip ? max(pieces, skip_pieces) : pieces;
#pragma unroll 2
  for (int j0 = 0; j0 < steps; j0 += 32) {
    const int j = j0 + lane;
    const int ji = min(j, pieces - 1), js = min(j, skip_pieces - 1);  // clamped: loads unconditional
    T a[kQueries][3], s[kQueries];
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
#pragma unroll
      for (int t = 0; t < 3; ++t) a[k][t] = rows[k][t][ji];
      if constexpr (kSkip) s[k] = skip_row[k][js];
    }
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      if (!live[k]) continue;
      if (j < pieces) {
        out_row[k][j] = Piece<kVec>::mix(a[k][0], a[k][1], a[k][2], wt[k][0], wt[k][1], wt[k][2]);
      }
      if constexpr (kSkip) {
        if (j < skip_pieces) out_row[k][pieces + j] = s[k];
      }
    }
  }
}

// ---------------------------------------------------------------- backward

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kWindow = 3072;  // slots staged at once: FP2's 3 x 1,024 in one window
constexpr int kStage = kWindow / kBwdThreads;  // slots a lane stages in a window
constexpr int kMaxRows = 512;  // rows a block may own
constexpr int kSlotBits = 12;  // a window slot's bits in a packed (row, slot)
constexpr int kBatch = 8;  // sorted slots whose loads a lane has in flight at once
static_assert(kWindow <= (1 << kSlotBits) && kWindow % 3 == 0, "a window packs and starts a query");

// The dynamic shared memory of a block owning up to `rows` rows: the
// window's packed in-range slots, the sorted slots, each warp's counts, the
// rows' starts and an end, the scan's warp sums, and each team's first row
// and an end.
constexpr long long bwd_smem_bytes(int rows) {
  return (2LL * kWindow + static_cast<long long>(kBwdWarps) * rows + rows + 1 + kBwdWarps +
          kBwdThreads + 1) * 4;
}
static_assert(bwd_smem_bytes(kMaxRows) <= 48 * 1024, "a block's shared memory without an opt-in");

// In-place exclusive prefix sum of v[0, len) by the block, the total into
// v[len]; visible after the next barrier.
__device__ void block_scan(int* v, int len, int* red) {
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int per = (len + kBwdThreads - 1) / kBwdThreads;
  const int lo = min(tid * per, len), hi = min(lo + per, len);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += v[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int k = 0; k < kBwdWarps; ++k) before += k < warp ? red[k] : 0;
  int run = before + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int x = v[i];
    v[i] = run;
    run += x;
  }
  if (tid == kBwdThreads - 1) v[len] = before + incl;
}

// A block a (scene, range of rows, slice of channel pieces), blockIdx.x =
// (scene * ranges + range) * slices + slice.
template <int kVec>
__global__ void __launch_bounds__(kBwdThreads)
three_interpolate_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                             const float* __restrict__ w, float* __restrict__ out, int n, int m,
                             int c, long long g_scene, long long g_row, int ranges, int slices) {
  using T = typename Piece<kVec>::T;
  extern __shared__ int smem[];
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1;  // the lanes before this one
  const int slice = static_cast<int>(blockIdx.x % slices);
  const int range = static_cast<int>(blockIdx.x / slices % ranges);
  const long long b = blockIdx.x / slices / ranges;
  const int lo = static_cast<int>(static_cast<long long>(range) * m / ranges);
  const int hi = static_cast<int>(static_cast<long long>(range + 1) * m / ranges);
  const int nr = hi - lo;
  const int row_cap = (m + ranges - 1) / ranges;  // the host sized the counts for this
  int* packed = smem;  // a warp's in-range slots from its segment's start: row << kSlotBits | slot
  int* sorted = packed + kWindow;  // the block's slots by row, ascending within a row
  int* counts = sorted + kWindow;  // a warp's counts, then its cursors, [warp][row]
  int* start = counts + kBwdWarps * row_cap;  // where each row's slots begin, and an end
  int* red = start + row_cap + 1;
  int* team_start = red + kBwdWarps;  // each team's first row, and an end
  int* my_counts = counts + warp * row_cap;

  // this slice's pieces, and the lanes of a team: a power of two, one piece each
  const int all_pieces = c / kVec;
  const int p0 = static_cast<int>(static_cast<long long>(slice) * all_pieces / slices);
  const int pieces = static_cast<int>(static_cast<long long>(slice + 1) * all_pieces / slices) - p0;
  int lanes = 1;
  while (lanes < 32 && lanes < (all_pieces + slices - 1) / slices) lanes <<= 1;
  const int teams = kBwdThreads / lanes, team = tid / lanes, lt = tid % lanes;

  const long long u = 3LL * n;
  const int* idx_b = idx + b * u;
  const float* w_b = w + b * u;
  const float* g_b = g + b * g_scene;
  float* out_b = out + (b * m + lo) * c;
  const long long g_stride = g_row / kVec, o_stride = c / kVec;

  for (long long s0 = 0; s0 < u; s0 += kWindow) {
    const bool first = s0 == 0;
    const int wn = static_cast<int>(min(static_cast<long long>(kWindow), u - s0));
    // 1. stage: warp w's contiguous segment [a0, a1) of the window, its
    //    slots in the block's rows packed in order from a0, and counted
    const int seg = (wn + 32 * kBwdWarps - 1) / (32 * kBwdWarps) * 32;
    const int a0 = min(warp * seg, wn), a1 = min(a0 + seg, wn);
    for (int r = lane; r < nr; r += 32) my_counts[r] = 0;
    __syncwarp();
    int kept = 0;  // warp-uniform
    if (a0 < a1) {  // warp-uniform
      int rr[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) rr[k] = idx_b[s0 + min(a0 + lane + 32 * k, a1 - 1)];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int s = a0 + lane + 32 * k;
        const int r = min(max(rr[k], 0), m - 1) - lo;
        const bool mine = s < a1 && r >= 0 && r < nr;
        const unsigned ballot = __ballot_sync(kFull, mine);
        if (mine) {
          const int at = a0 + kept + __popc(ballot & below);
          packed[at] = r << kSlotBits | s;
          atomicAdd(&my_counts[r], 1);
        }
        kept += __popc(ballot);
      }
    }
    __syncthreads();
    // 2. each row's slots, their scan into starts, each warp's cursor, and
    //    each team's first row: team t's rows [ra, rb) are cut by work, ra
    //    the first row r whose weighted start, start[r] + r, reaches
    //    ceil(t work / teams), the rows r with t in (T(r - 1), T(r)] for
    //    T(r) = floor((start[r] + r) teams / work)
    for (int r = tid; r < nr; r += kBwdThreads) {
      int total = 0;
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k) total += counts[k * row_cap + r];
      start[r] = total;
    }
    __syncthreads();
    block_scan(start, nr, red);
    __syncthreads();
    const long long work = static_cast<long long>(start[nr]) + nr;
    for (int r = tid; r <= nr; r += kBwdThreads) {
      if (r < nr) {
        int run = start[r];
#pragma unroll
        for (int k = 0; k < kBwdWarps; ++k) {
          const int x = counts[k * row_cap + r];
          counts[k * row_cap + r] = run;
          run += x;
        }
      }
      const int t_lo = r == 0 ? 0 : static_cast<int>((start[r - 1] + r - 1LL) * teams / work) + 1;
      const int t_hi = static_cast<int>((start[r] + static_cast<long long>(r)) * teams / work);
      for (int t = t_lo; t <= t_hi; ++t) team_start[t] = r;
    }
    __syncthreads();
    // 3. place: ascending within a row, warp by warp and lane by lane
    for (int c0 = 0; c0 < kept; c0 += 32) {  // warp-uniform
      const bool mine = c0 + lane < kept;
      const int pk = mine ? packed[a0 + c0 + lane] : -1;
      const int r = pk >> kSlotBits;  // -1 for no slot
      const unsigned peers = __match_any_sync(kFull, r);
      const int rank = __popc(peers & below);
      int base = 0;
      if (mine) {
        base = my_counts[r];
        sorted[base + rank] = pk & ((1 << kSlotBits) - 1);
      }
      __syncwarp();
      if (mine && rank == 0) my_counts[r] = base + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // 4. sum: team t owns rows [ra, rb)
    const int ra = team_start[team], rb = team_start[team + 1];
    if (ra < rb) {
      const int e_end = start[rb];
      for (int j = lt; j < pieces; j += lanes) {
        // g's rows of this window's queries (kWindow is a multiple of 3), and their weights
        const T* g_col = reinterpret_cast<const T*>(g_b) + s0 / 3 * g_stride + p0 + j;
        const float* w_win = w_b + s0;
        T* o_col = reinterpret_cast<T*>(out_b) + p0 + j;
        // a later window adds to what the earlier ones wrote
        auto open = [&](int r) { return first ? Piece<kVec>::zero() : o_col[r * o_stride]; };
        int cur = ra, next = start[ra + 1];
        T acc = open(cur);
        for (int e0 = start[ra]; e0 < e_end; e0 += kBatch) {
          T v[kBatch];
          float wv[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {  // every load first, from clamped entries
            const int slot = sorted[min(e0 + k, e_end - 1)];
            v[k] = g_col[slot / 3 * g_stride];
            wv[k] = w_win[slot];
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int e = e0 + k;
            if (e < e_end) {
              while (e >= next) {
                o_col[cur * o_stride] = acc;
                acc = open(++cur);
                next = start[cur + 1];
              }
              acc = Piece<kVec>::add_product(acc, v[k], wv[k]);
            }
          }
        }
        o_col[cur * o_stride] = acc;
        if (first) {  // rows past the last slot; later windows leave them as they are
          for (int r = cur + 1; r < rb; ++r) o_col[r * o_stride] = Piece<kVec>::zero();
        }
      }
    }
    __syncthreads();  // before the next window overwrites the shared memory
  }
}

}  // namespace

// features: (b, m, c) f32; idx: (b, n, 3) i32; weight: (b, n, 3) f32; skip:
// (b, n, cs) f32 or null with cs 0; out: (b, n, c + cs) f32, written in full,
// [interpolated | skip]. vec 4 takes 16-byte pieces (c and cs multiples of 4,
// features, skip and out 16-byte aligned), vec 1 single floats. Returns
// cudaErrorInvalidValue for a shape the kernel cannot take.
extern "C" int three_interpolate_launch(const float* features, const int* idx, const float* weight,
                                        const float* skip, float* out, int b, int n, int m, int c,
                                        int cs, int vec, cudaStream_t stream) {
  const long long queries = static_cast<long long>(b) * n;
  const long long blocks = (queries + kTile - 1) / kTile;
  if (b < 1 || n < 1 || m < 1 || c < 1 || cs < 0 || (cs > 0) != (skip != nullptr) ||
      blocks >= (1LL << 31) || (vec != 1 && vec != 4) || c % vec || cs % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec == 4 && cs > 0) {
    three_interpolate_kernel<4, true><<<grid, kFwdThreads, 0, stream>>>(
        features, idx, weight, skip, out, queries, n, m, c, cs);
  } else if (vec == 4) {
    three_interpolate_kernel<4, false><<<grid, kFwdThreads, 0, stream>>>(
        features, idx, weight, skip, out, queries, n, m, c, cs);
  } else if (cs > 0) {
    three_interpolate_kernel<1, true><<<grid, kFwdThreads, 0, stream>>>(
        features, idx, weight, skip, out, queries, n, m, c, cs);
  } else {
    three_interpolate_kernel<1, false><<<grid, kFwdThreads, 0, stream>>>(
        features, idx, weight, skip, out, queries, n, m, c, cs);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: the cotangent of the interpolated half, (b, n, c) f32 at element
// strides (g_scene, g_row, 1); idx, weight: (b, n, 3) i32 and f32; out: (b,
// m, c) f32, every element written here. `ranges` row ranges a scene, each
// of at most kMaxRows rows, `slices` slices of the channel pieces. vec 4
// takes 16-byte pieces (c, g_scene and g_row multiples of 4, g 16-byte
// aligned). Returns cudaErrorInvalidValue for a launch that cannot run.
extern "C" int three_interpolate_bwd_launch(const float* g, const int* idx, const float* weight,
                                            float* out, int b, int n, int m, int c,
                                            long long g_scene, long long g_row, int ranges,
                                            int slices, int vec, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1 || c < 1 || ranges < 1 || ranges > m ||
      (m + ranges - 1) / ranges > kMaxRows || (vec != 1 && vec != 4) || c % vec ||
      g_scene % vec || g_row % vec || slices < 1 || slices > c / vec ||
      static_cast<long long>(b) * ranges * slices >= (1LL << 31) || n > (1 << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(bwd_smem_bytes((m + ranges - 1) / ranges));
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(b) * ranges * slices);
  if (vec == 4) {
    three_interpolate_bwd_kernel<4><<<blocks, kBwdThreads, bytes, stream>>>(
        g, idx, weight, out, n, m, c, g_scene, g_row, ranges, slices);
  } else {
    three_interpolate_bwd_kernel<1><<<blocks, kBwdThreads, bytes, stream>>>(
        g, idx, weight, out, n, m, c, g_scene, g_row, ranges, slices);
  }
  return static_cast<int>(cudaGetLastError());
}
