// Three nearest neighbours: for each query point of a scene, the indices of
// the 3 nearest of the scene's seed points and the distances to them.
//
// Replaces the XLA program iou3dmatch_tpu/ops/interpolate.py::three_nn
// (exact=True, interpolate.py:20-68: three fused argmin passes over an
// elementwise d2), itself the counterpart of the reference ThreeNN
// (interpolate_gpu.cu:14-74). The port calls it from GridConv (16,384 grid
// points a scene against 1,024 seeds in training, 8,192 in serving) and
// from FP1 and FP2 (512 x 256 and 1,024 x 512).
//
// What bounds it on the H100: operations. Each (query, seed) pair costs 3
// subtractions, 3 products, 2 sums and a compare, none fused (the file is
// built with -fmad=false, see ops/_build.py); the bytes (the queries, the
// seeds and the outputs, each once) are a few MB. So the seeds never leave
// the chip, and nothing but the outputs goes to HBM.
//
// The order. A seed's key is (NaN first, then d2, then its index); the
// answer is the 3 least keys, with (+inf, 0) slots where fewer than 3
// seeds have a finite d2 (m < 3, or distances that overflow): +inf never
// enters, and the plain version's argmin passes then pick index 0, the
// first of an all-inf row. That is what a scan in index order gives when a
// seed takes a slot only strictly before it (ops/interpolate.py::
// three_nn_plain, JAX), and, being a choice of the least keys, it does not
// depend on how the seeds are split or in what order the parts merge.
//
// The design, templated on S lanes a query and Q queries a thread
// (ops/interpolate.py::three_nn_plan picks them, NN_CASE below lists them):
//
// - a block of kThreads threads holds kThreads / S x Q queries of one
//   scene; lane `sub` of a query's S lanes scans the 4-seed groups g with
//   g % S == sub, in index order, and keeps its own top 3 in registers, so
//   a seed enters its lane's list by d2 alone (a later seed of the lane
//   has a higher index); the 0-3 seeds after the last whole group go to
//   lane 0, after its groups. The list holds keys, fmaxf(d2, -1): a NaN
//   d2 becomes -1, before every number, and equal keys keep the earlier
//   seed;
// - the S lists then merge by __shfl_xor_sync over xor distances 1, 2, ...
//   S / 2: each lane keeps the 3 least keys of its list and its partner's
//   (a half-cleaner, then 3 compare-exchanges), so every lane of a query
//   ends with the same list;
// - the block stages its scene's seeds in shared memory as they lie in
//   memory (x y z x y z ...), kTile seeds at a time with cp.async (16-byte
//   copies where the scene starts on a 16-byte boundary), so any m works;
//   four seeds are 48 contiguous bytes, three float4 loads that the query
//   groups of a warp share (S <= 8 distinct groups fill at most the 32
//   banks once);
// - each group's four distance tests against each of the Q queries end in
//   one compare and branch for the four (none enters in the common case),
//   so each shared load serves 4 Q tests; where one may enter, each of the
//   four takes its own branch around a branch-free insert (3 compares, 5
//   min/max and 5 selects). The warp takes that path whenever any lane
//   needs it: 16 % of group steps at GridConv, nearly all at FP, where the
//   lanes hold queries far apart (PERF.md). An insert that branches on
//   each slot would run, there, each slot's path in turn.
//
// Exactness against the plain version and JAX: d2 is (dx dx + dy dy) + dz
// dz with dx = u.x - k.x, each difference, product and sum rounded on its
// own (__fsub_rn, __fmul_rn, __fadd_rn); dist is __fsqrt_rn of the
// selected seeds' d2 computed again (from shared memory where one tile
// holds every seed), as the plain version computes it.
//
// Built with -DTHREE_NN_COUNTS (chip_smoke.py --nn-counts), lane 0 of each
// warp counts its 4-seed group steps (one group against one query), those
// on which the warp took the insert path, and clock64() cycles spent
// staging, scanning, merging and writing, summed over the warps into
// nn_counts and read back by three_nn_counts_read. The kernels' own build
// leaves the counters out.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#ifdef THREE_NN_COUNTS
// warps, group steps, steps that took the insert path, cycles staging,
// scanning, merging, writing
__device__ unsigned long long nn_counts[7];
#define NN_MARK(acc)                   \
  {                                    \
    const long long now = clock64();   \
    acc += now - mark;                 \
    mark = now;                        \
  }
#else
#define NN_MARK(acc)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // ops/interpolate.py NN_THREADS
constexpr int kTile = 1024;    // seeds staged a time: 12 KB

__device__ __forceinline__ float sq_dist(float ux, float uy, float uz, float kx, float ky, float kz) {
  const float dx = __fsub_rn(ux, kx), dy = __fsub_rn(uy, ky), dz = __fsub_rn(uz, kz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// a lane's insert of seed j, a later seed than any it holds, into its
// sorted keys kk (fmaxf takes the number: a NaN d2 becomes -1), branch-free
__device__ __forceinline__ void insert(float d, int j, float (&kk)[3], int (&ii)[3]) {
  const float k = fmaxf(d, -1.0f);
  const bool c0 = k < kk[0], c1 = k < kk[1], c2 = k < kk[2];
  ii[2] = c1 ? ii[1] : (c2 ? j : ii[2]);
  ii[1] = c0 ? ii[0] : (c1 ? j : ii[1]);
  ii[0] = c0 ? j : ii[0];
  kk[2] = fminf(kk[2], fmaxf(kk[1], k));
  kk[1] = fminf(kk[1], fmaxf(kk[0], k));
  kk[0] = fminf(kk[0], k);
}

// where it may enter: NaN and any d2 under the third key (a NaN fails >=)
__device__ __forceinline__ void maybe_insert(float d, int j, float (&kk)[3], int (&ii)[3]) {
  if (!(d >= kk[2])) insert(d, j, kk, ii);
}

// the merge's order: the key, then the lower index
__device__ __forceinline__ bool key_before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

__device__ __forceinline__ void keep_least(float& d, int& i, float e, int j) {
  const bool take = key_before(e, j, d, i);
  d = take ? e : d;
  i = take ? j : i;
}

__device__ __forceinline__ void order(float& d0, int& i0, float& d1, int& i1) {
  const bool swap = key_before(d1, i1, d0, i0);
  const float d = d0;
  const int i = i0;
  d0 = swap ? d1 : d0;
  i0 = swap ? i1 : i0;
  d1 = swap ? d : d1;
  i1 = swap ? i : i1;
}

// this lane's sorted list and that of lane ^ off -> the 3 least of both,
// sorted: the same list in both lanes
__device__ __forceinline__ void merge(float (&kk)[3], int (&ii)[3], int off) {
  float e[3];
  int j[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    e[s] = __shfl_xor_sync(kFull, kk[s], off);
    j[s] = __shfl_xor_sync(kFull, ii[s], off);
  }
  keep_least(kk[0], ii[0], e[2], j[2]);
  keep_least(kk[1], ii[1], e[1], j[1]);
  keep_least(kk[2], ii[2], e[0], j[0]);
  order(kk[0], ii[0], kk[1], ii[1]);
  order(kk[1], ii[1], kk[2], ii[2]);
  order(kk[0], ii[0], kk[1], ii[1]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// copies `count` seeds from src into dst, as they lie, and waits for them.
// `vec`: src starts on a 16-byte boundary
__device__ __forceinline__ void stage(float* dst, const float* src, int count, bool vec) {
  const int nf = 3 * count;
  const int nv = vec ? nf >> 2 : 0;
  for (int k = threadIdx.x; k < nv; k += kThreads) cp_async16(dst + 4 * k, src + 4 * k);
  for (int k = 4 * nv + threadIdx.x; k < nf; k += kThreads) cp_async4(dst + k, src + k);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// grid b x per_scene blocks, scene-major (any b); kThreads threads
template <int S, int Q>
__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                float* __restrict__ dist, int* __restrict__ idx, int n, int m, int per_scene) {
  static_assert(32 % S == 0, "a query's lanes lie in one warp");
  constexpr int kRows = kThreads / S;  // queries the block holds side by side
  __shared__ __align__(16) float sk[3 * kTile];
  const int scene = blockIdx.x / per_scene;
  const int sub = threadIdx.x % S;
  const int q0 = (blockIdx.x - scene * per_scene) * kRows * Q + threadIdx.x / S;
  const float* seeds = known + static_cast<long long>(scene) * m * 3;
#ifdef THREE_NN_COUNTS
  long long mark = clock64(), c_stage = 0, c_scan = 0, c_merge = 0, c_write = 0;
  unsigned long long steps = 0, inserts = 0;
#endif

  // query k of this thread is q0 + k kRows; past n it repeats the last
  // query, so every lane takes part in the shuffles, and writes nothing
  float ux[Q], uy[Q], uz[Q], kk[Q][3];
  int ii[Q][3];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const long long row = static_cast<long long>(scene) * n + min(q0 + k * kRows, n - 1);
    ux[k] = unknown[row * 3], uy[k] = unknown[row * 3 + 1], uz[k] = unknown[row * 3 + 2];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      kk[k][s] = CUDART_INF_F;
      ii[k][s] = 0;
    }
  }

  const bool vec = (reinterpret_cast<uintptr_t>(seeds) & 15u) == 0;  // tiles are 12 KB apart
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    stage(sk, seeds + 3LL * t0, cnt, vec);
    __syncthreads();
    NN_MARK(c_stage);
    const int groups = cnt >> 2;
#pragma unroll 2
    for (int g = sub; g < groups; g += S) {
      const float4* p = reinterpret_cast<const float4*>(sk + 12 * g);
      const float4 a = p[0], b = p[1], c = p[2];
      const int j = t0 + 4 * g;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const float d0 = sq_dist(ux[k], uy[k], uz[k], a.x, a.y, a.z);
        const float d1 = sq_dist(ux[k], uy[k], uz[k], a.w, b.x, b.y);
        const float d2 = sq_dist(ux[k], uy[k], uz[k], b.z, b.w, c.x);
        const float d3 = sq_dist(ux[k], uy[k], uz[k], c.y, c.z, c.w);
        // none of the four may enter (a NaN fails every >=)
        const bool none = d0 >= kk[k][2] && d1 >= kk[k][2] && d2 >= kk[k][2] && d3 >= kk[k][2];
#ifdef THREE_NN_COUNTS
        ++steps;
        inserts += __any_sync(__activemask(), !none);
#endif
        if (none) continue;
        maybe_insert(d0, j, kk[k], ii[k]);
        maybe_insert(d1, j + 1, kk[k], ii[k]);
        maybe_insert(d2, j + 2, kk[k], ii[k]);
        maybe_insert(d3, j + 3, kk[k], ii[k]);
      }
    }
    if (sub == 0) {
      for (int j = 4 * groups; j < cnt; ++j) {
#pragma unroll
        for (int k = 0; k < Q; ++k)
          maybe_insert(sq_dist(ux[k], uy[k], uz[k], sk[3 * j], sk[3 * j + 1], sk[3 * j + 2]),
                       t0 + j, kk[k], ii[k]);
      }
    }
    NN_MARK(c_scan);
  }

#pragma unroll
  for (int off = 1; off < S; off <<= 1) {
#pragma unroll
    for (int k = 0; k < Q; ++k) merge(kk[k], ii[k], off);
  }
  NN_MARK(c_merge);

  // lane sub of a query writes the slots s with s % S == sub
  const float* held = m <= kTile ? sk : seeds;  // one tile: every seed is still staged
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = q0 + k * kRows;
    if (q >= n) continue;
    const long long row = static_cast<long long>(scene) * n + q;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s % S != sub) continue;
      const float* p = held + 3LL * ii[k][s];
      dist[row * 3 + s] = __fsqrt_rn(sq_dist(ux[k], uy[k], uz[k], p[0], p[1], p[2]));
      idx[row * 3 + s] = ii[k][s];
    }
  }
#ifdef THREE_NN_COUNTS
  NN_MARK(c_write);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&nn_counts[0], 1ull);
    atomicAdd(&nn_counts[1], steps);
    atomicAdd(&nn_counts[2], inserts);
    atomicAdd(&nn_counts[3], static_cast<unsigned long long>(c_stage));
    atomicAdd(&nn_counts[4], static_cast<unsigned long long>(c_scan));
    atomicAdd(&nn_counts[5], static_cast<unsigned long long>(c_merge));
    atomicAdd(&nn_counts[6], static_cast<unsigned long long>(c_write));
  }
#endif
}

template <int S, int Q>
cudaError_t launch(const float* unknown, const float* known, float* dist, int* idx, int b, int n,
                   int m, cudaStream_t stream) {
  constexpr int per_block = kThreads / S * Q;
  const int per_scene = (n + per_block - 1) / per_block;
  if (static_cast<long long>(b) * per_scene > INT_MAX) return cudaErrorInvalidValue;
  three_nn_kernel<S, Q><<<b * per_scene, kThreads, 0, stream>>>(unknown, known, dist, idx, n, m,
                                                                 per_scene);
  return cudaGetLastError();
}

}  // namespace

// unknown: (b, n, 3) f32; known: (b, m, 3) f32, m >= 1; dist: (b, n, 3)
// f32 and idx: (b, n, 3) int32, written in full. (lanes, queries) must be
// one of the NN_CASEs (ops/interpolate.py NN_LAUNCHES).
extern "C" int three_nn_launch(const float* unknown, const float* known, float* dist, int* idx,
                               int b, int n, int m, int lanes, int queries, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
#define NN_CASE(S, Q)             \
  if (lanes == S && queries == Q) \
  return static_cast<int>(launch<S, Q>(unknown, known, dist, idx, b, n, m, stream))
  NN_CASE(1, 1);
  NN_CASE(1, 2);
  NN_CASE(1, 4);
  NN_CASE(2, 1);
  NN_CASE(2, 2);
  NN_CASE(2, 4);
  NN_CASE(4, 1);
  NN_CASE(4, 2);
  NN_CASE(4, 4);
  NN_CASE(8, 1);
  NN_CASE(8, 2);
  NN_CASE(8, 4);
  NN_CASE(16, 1);
  NN_CASE(16, 2);
  NN_CASE(16, 4);
  NN_CASE(32, 1);
  NN_CASE(32, 2);
  NN_CASE(32, 4);
#undef NN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef THREE_NN_COUNTS
// the totals since the last read, (7,) uint64, then zeroes them
extern "C" int three_nn_counts_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, nn_counts, sizeof(nn_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zeros[7] = {};
  return static_cast<int>(cudaMemcpyToSymbol(nn_counts, zeros, sizeof(zeros)));
}
#endif
