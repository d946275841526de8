// Backward of the grouping gather: a segment sum of the cotangent rows into
// the table rows they were gathered from,
// grad_table[b, clamp(idx[b, u], 0, n - 1), :] += g[b, u, :].
//
// Replaces the custom VJP of iou3dmatch_tpu/ops/ball_query.py::group_points
// (_group_bwd -> ops/scatter.py::batched_onehot_segment_sum), which wrote
// the scatter-add as a one-hot matmul for the TPU's matrix unit, because a
// TPU scatter serializes. The pretrain step runs it four times (SA2, SA3,
// SA4 and vote aggregation; SA1's table is the point cloud and GridConv's
// seeds are detached, so neither needs it).
//
// What bounds it on the H100: bytes. g (17 to 137 MB at the step's shapes)
// is read once from device memory and the output (4 to 9 MB) written once.
// A first version added each element of g into a zeroed output with an f32
// atomic in L2: 34 M atomics at SA2, a separate memset, 40 % of the byte
// bound. Here every output row has one owner, a warp, which sums the row's
// cotangent rows in registers and writes the row once; nothing is zeroed
// and no float is added atomically. Two kernels, one call of the wrapper:
//
// 1. gather_bwd_list_kernel sorts each scene's slots by their clamped index
//    (a counting sort: row counts, a prefix sum, a scatter) into `perm`, the
//    slots, and `erow`, each sorted slot's row. A scene's rows are split
//    among `lists` blocks of 1,024 threads; each block reads all of the
//    scene's indices (4 bytes a slot, from L2) and so needs no other block:
//    the slots below its rows give where its rows begin in the sorted list.
//    It counts, scans and scatters its own rows with shared-memory integer
//    atomics, which are native. It also cuts the list into `runs` runs of
//    whole rows of about equal work, a row's write weighing a slot's add:
//    the ball query names rows in scan order, so a scene's low rows are the
//    first hits of many balls and fill the slots of balls with few hits,
//    and hold several times the mean number of slots, while at vote
//    aggregation most rows get no slot and only zeros.
// 2. gather_bwd_sum_kernel gives each (run, group of kChunks 32-channel
//    chunks) a warp: lane l sums channel 32 q + l of chunk q over the run's
//    sorted slots, kEntries slots' loads in flight at once, and writes a row
//    when the next slot names another; rows no slot names get zeros. Its
//    loads are unconditional, from addresses clamped into g: a predicated
//    load whose result a select then zeroes makes the next load wait for it,
//    which serialized an earlier version.
//
// Designs measured before this one on the H100 (PERF.md): blocks that
// own a slab of rows in shared memory and add with shared f32 atomicAdd,
// which Hopper runs as a compare-and-swap loop, spun on the hot rows; warps
// that own rows of such a slab, without atomics, lost to the skew and to
// every block reading its scene's indices with a division a slot; one list
// block a scene, or one cluster of 8, took 7 to 30 us. Slots are summed in
// the order the sort's atomics gave them, so the last bits of a sum may
// change from run to run. Offsets into g and the output are 64-bit.
// three_interpolate's backward, another segment sum, has a one-launch kernel
// of its own with a fixed sum order (csrc/three_interpolate.cu).
#include <cuda_runtime.h>

namespace {

constexpr int kListThreads = 1024;
constexpr int kListBatch = 16;     // indices a list thread has in flight at once
constexpr int kListRows = 8192;    // rows a list block may own: its counts in shared memory
constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;  // runs a sum block
constexpr int kChunks = 3;  // 32-channel chunks a sum warp holds: C split in groups of 96
constexpr int kEntries = 8;  // sorted slots whose loads a sum warp has in flight at once

// The sum of v over the block; every thread gets it after the barrier inside.
__device__ int block_sum(int v, int* red) {
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kListThreads / 32; ++w) total += red[w];
  return total;
}

// In-place exclusive prefix sum of v[0, len), plus base, by one block.
// v's new values are visible after the next barrier.
__device__ void block_scan(int* v, int len, int base, int* red) {
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int per = (len + kListThreads - 1) / kListThreads;
  const int lo = min(tid * per, len), hi = min(lo + per, len);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += v[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kListThreads / 32; ++w) before += w < warp ? red[w] : 0;
  int run = base + before + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int x = v[i];
    v[i] = run;
    run += x;
  }
}

// The first i of [0, len) whose weighted start, start[i] + first_row + i, is
// at least target, or len.
__device__ __forceinline__ int lower_bound(const int* start, int len, int first_row,
                                           long long target) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(start[mid]) + first_row + mid < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A thread's kListBatch slots from s0 on, kListThreads apart, clamped to
// rows; all loads first (a slot past u reads slot u - 1 and is not used).
__device__ __forceinline__ void load_rows(int (&t)[kListBatch], const int* __restrict__ idx, int s0,
                                          int u, int n) {
#pragma unroll
  for (int k = 0; k < kListBatch; ++k) t[k] = idx[min(s0 + k * kListThreads, u - 1)];
#pragma unroll
  for (int k = 0; k < kListBatch; ++k) t[k] = min(max(t[k], 0), n - 1);
}

// `lists` blocks a scene, block k owning rows [k n / lists, (k + 1) n /
// lists). Each reads all of its scene's indices (from L2), so it needs no
// other block: the slots below its rows are where its rows' slots begin in
// the sorted list, and those in the row just below decide which runs start
// in its rows.
__global__ void __launch_bounds__(kListThreads)
gather_bwd_list_kernel(const int* __restrict__ idx, int* __restrict__ perm, int* __restrict__ erow,
                       int* __restrict__ wrow, int* __restrict__ went, int n, int u, int runs,
                       int lists) {
  __shared__ int start[kListRows];  // this block's rows' counts, then starts, then cursors
  __shared__ int red[kListThreads / 32];
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31;
  const long long b = blockIdx.x / lists;
  const int k = static_cast<int>(blockIdx.x % lists);
  const int lo = static_cast<int>(static_cast<long long>(k) * n / lists);
  const int hi = static_cast<int>(static_cast<long long>(k + 1) * n / lists);
  const int nr = hi - lo;
  const int* idx_b = idx + b * u;
  for (int i = tid; i < nr; i += kListThreads) start[i] = 0;
  __syncthreads();

  int below = 0, just_below = 0;
  for (int s0 = tid; s0 - lane < u; s0 += kListThreads * kListBatch) {  // warp-uniform
    int t[kListBatch];
    load_rows(t, idx_b, s0, u, n);
#pragma unroll
    for (int j = 0; j < kListBatch; ++j) {
      if (s0 + j * kListThreads < u) {
        below += t[j] < lo;
        just_below += t[j] == lo - 1;
        if (t[j] >= lo && t[j] < hi) atomicAdd(&start[t[j] - lo], 1);
      }
    }
  }
  const int base = block_sum(below, red);
  __syncthreads();
  const int prev_start = base - block_sum(just_below, red);  // where row lo - 1 starts
  __syncthreads();
  block_scan(start, nr, base, red);
  __syncthreads();
  // Runs are cut by work, a row's write weighing as much as a slot's add:
  // run j starts at the first row whose weighted start, where its slots
  // start plus its index, is at least ceil(j (u + n) / runs). That row is
  // here if one of this block's rows qualifies and row lo - 1 does not;
  // past the last row, run j starts at N.
  int* wr = wrow + b * (runs + 1);
  int* we = went + b * (runs + 1);
  for (int j = tid; j < runs; j += kListThreads) {
    const long long target = (j * (static_cast<long long>(u) + n) + runs - 1) / runs;
    const int r = lower_bound(start, nr, lo, target);
    if (r < nr && (k == 0 || static_cast<long long>(prev_start) + lo - 1 < target)) {
      wr[j] = lo + r;
      we[j] = start[r];
    } else if (r == nr && k == lists - 1) {
      wr[j] = n;
      we[j] = u;
    }
  }
  if (k == lists - 1 && tid == 0) {
    wr[runs] = n;
    we[runs] = u;
  }
  __syncthreads();

  int* perm_b = perm + b * u;
  int* erow_b = erow + b * u;
  for (int s0 = tid; s0 - lane < u; s0 += kListThreads * kListBatch) {
    int t[kListBatch];
    load_rows(t, idx_b, s0, u, n);
#pragma unroll
    for (int j = 0; j < kListBatch; ++j) {
      const int s = s0 + j * kListThreads;
      if (s < u && t[j] >= lo && t[j] < hi) {
        const int pos = atomicAdd(&start[t[j] - lo], 1);
        perm_b[pos] = s;
        erow_b[pos] = t[j];
      }
    }
  }
}

// A warp a (run, group of kChunks 32-channel chunks).
__global__ void __launch_bounds__(kSumThreads, 4)
gather_bwd_sum_kernel(const float* __restrict__ g, const int* __restrict__ perm,
                      const int* __restrict__ erow, const int* __restrict__ wrow,
                      const int* __restrict__ went,
                      float* __restrict__ out, int n, int u, int c, int parts, int splits) {
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int runs = parts * kSumWarps;
  const long long b = blockIdx.x / (parts * splits);
  const int rest = static_cast<int>(blockIdx.x % (parts * splits));
  const int q0 = rest / parts * kChunks;  // this warp's first chunk
  const int j = rest % parts * kSumWarps + warp;
  const int r_lo = wrow[b * (runs + 1) + j], r_hi = wrow[b * (runs + 1) + j + 1];
  const int e_lo = went[b * (runs + 1) + j], e_hi = went[b * (runs + 1) + j + 1];
  if (r_lo >= r_hi) return;  // a run of no rows
  const int* perm_b = perm + b * u;
  const int* erow_b = erow + b * u;
  const float* g_b = g + b * u * c;
  float* out_b = out + b * n * c;

  int col[kChunks];  // this lane's channel of each chunk, clamped into the row
  float acc[kChunks];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    col[q] = min(((q0 + q) << 5) + lane, c - 1);
    acc[q] = 0.f;
  }
  int cur = r_lo;
  // writes row cur's sums, then zeros in the rows up to `upto`
  auto flush = [&](int upto) {
    for (int r = cur; r < upto; ++r) {
      float* o = out_b + static_cast<long long>(r) * c;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int ch = ((q0 + q) << 5) + lane;
        if (ch < c) o[ch] = acc[q];
        acc[q] = 0.f;
      }
    }
  };
  for (int eb = e_lo; eb < e_hi; eb += 32) {
    const int batch = min(32, e_hi - eb);
    const int my_slot = perm_b[min(eb + lane, e_hi - 1)];
    const int my_row = erow_b[min(eb + lane, e_hi - 1)];
    for (int i = 0; i < batch; i += kEntries) {
      float v[kEntries][kChunks];
#pragma unroll
      for (int a = 0; a < kEntries; ++a) {
        const int slot = __shfl_sync(0xffffffffu, my_slot, (i + a) & 31);
        const float* src = g_b + static_cast<long long>(slot) * c;
#pragma unroll
        for (int q = 0; q < kChunks; ++q) v[a][q] = src[col[q]];
      }
#pragma unroll
      for (int a = 0; a < kEntries; ++a) {
        const int row = __shfl_sync(0xffffffffu, my_row, (i + a) & 31);
        if (i + a < batch) {
          if (row != cur) {
            flush(row);
            cur = row;
          }
#pragma unroll
          for (int q = 0; q < kChunks; ++q) acc[q] += v[a][q];
        }
      }
    }
  }
  flush(r_hi);
}

}  // namespace

// g: (b, u, c) f32; idx: (b, u) i32; out: (b, n, c) f32, every element
// written here; scratch: 2 b u + 2 b (8 parts + 1) i32. The list kernel
// runs `lists` blocks a scene, each owning at most kListRows rows; the sum
// kernel `parts` blocks of 8 runs a scene for each group of 96 channels.
// Returns cudaErrorInvalidValue for a launch that cannot run.
extern "C" int gather_bwd_launch(const float* g, const int* idx, float* out, int* scratch, int b,
                                 int n, int u, int c, int parts, int lists, cudaStream_t stream) {
  const int splits = ((c + 31) / 32 + kChunks - 1) / kChunks;
  if (b < 1 || n < 1 || u < 1 || c < 1 || parts < 1 || parts >= (1 << 26) || lists < 1 ||
      lists > n || (n + lists - 1) / lists > kListRows ||
      static_cast<long long>(b) * parts * splits >= (1LL << 31) ||
      static_cast<long long>(b) * lists >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int runs = parts * kSumWarps;
  int* perm = scratch;
  int* erow = perm + static_cast<long long>(b) * u;
  int* wrow = erow + static_cast<long long>(b) * u;
  int* went = wrow + static_cast<long long>(b) * (runs + 1);
  gather_bwd_list_kernel<<<b * lists, kListThreads, 0, stream>>>(idx, perm, erow, wrow, went, n, u,
                                                                 runs, lists);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(b) * parts * splits);
  gather_bwd_sum_kernel<<<blocks, kSumThreads, 0, stream>>>(g, perm, erow, wrow, went, out, n, u,
                                                             c, parts, splits);
  return static_cast<int>(cudaGetLastError());
}

