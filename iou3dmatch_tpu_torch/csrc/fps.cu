// Furthest point sampling, one thread-block cluster per scene.
//
// Replaces the Pallas kernel iou3dmatch_tpu/ops/fps_pallas.py::_fps_kernel
// (dispatched from iou3dmatch_tpu/ops/fps.py::furthest_point_sample).
// Semantics: seed index 0; points with |p|^2 <= 1e-3 are never chosen; a
// running min of squared distances to the chosen set; each step takes the
// argmax, the lowest index winning on equal values.
//
// What bounds it on the H100: the npoint-1 dependent steps, not bytes or
// flops (about 9 operations per point and step, the cloud read once). Each
// step is a pass over the scene's points, an argmax over all of them, and
// the winner's coordinates handed to every thread for the next step; what a
// step costs is the latency of that chain. The design shortens it:
//
// - A scene is split over a cluster of S blocks on S SMs (S <= 16, chosen
//   in ops/fps.py so that B x S blocks run in one wave). Block r owns the
//   points [r * share, (r + 1) * share) of its scene.
// - The share stays on chip for the whole run: in registers (kPPT points a
//   thread, loops fully unrolled, (x, y, z, min distance) per point), or in
//   shared memory (kShared, 16 bytes a point) where registers do not hold
//   it. Only a share too large for shared memory streams its coordinates
//   from global memory (L2) with its min distances in a global scratch row
//   (kGlobal), as the one-block-per-scene design did for every size.
// - One step: a per-thread first maximum over its points; a warp argmax
//   (two redux.sync instructions, larger value then lower index, and one
//   broadcast of the winner); a block argmax in warp 0 the same way; then
//   lane l of warp 0 writes the block's candidate (value, index, x, y, z)
//   into slot [j & 1][r] of block l through distributed shared memory and
//   arrives, with release semantics, on block l's mbarrier s_full[j & 1].
//   Each block waits (acquire) on its own s_full[j & 1] until all S blocks
//   have arrived, reduces the S candidates with one more warp argmax, and
//   takes the winner's coordinates from the candidate. Nothing in the chain
//   touches global memory apart from rank 0 writing out[j]; no block waits
//   for all threads of the cluster, only for the S candidates it needs.
//
// What bounds it now: the per-step latency of the block reduction and of
// one remote write plus arrive between SMs. Measured against one cluster
// barrier a step with shuffle reductions, this exchange was the fastest at
// the planned shapes (PERF.md), and S = 8 beats S = 16 there.
//
// Why the double buffer is safe with one mbarrier phase a step: block X
// writes slot s = j & 1 of block Y at step j and again at step j + 2. To be
// at step j + 2, X has waited out step j + 1, which needs Y's arrival of
// step j + 1; Y's warp 0 arrives only after Y's __syncthreads of step
// j + 1, which every warp of Y reaches after it has consumed slot s of step
// j (the redux that reads it is warp-collective). The arrive's release and
// the wait's acquire order those reads before X's writes. For the same
// reason a barrier's phase cannot complete twice before its owner waits on
// it, so the parity ((j - 1) >> 1) & 1 names the phase of step j; and the
// per-warp scratch s_warp is rewritten only after the same wait. A cluster
// sync after the mbarrier init makes every block's barriers visible before
// the first remote arrive, and one before exit keeps a block from leaving
// while the cluster still runs.
//
// A block whose share is empty or holds only padding offers (-inf, INT_MAX);
// invalid points offer -1 with their index. N >= 1, so a real candidate
// always exists.
//
// Distances are rounded product by product (__fmul_rn / __fadd_rn /
// __fsub_rn), so no FMA contraction changes a near-tie against the plain
// PyTorch version.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kShared = 0;   // kPPT value: the share in shared memory
constexpr int kGlobal = -1;  // kPPT value: the share streamed from global memory
constexpr unsigned kFull = 0xffffffffu;

struct Cand {
  float v;
  int i;
  float x, y, z;
};

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float init_dist(float x, float y, float z) {
  // invalid points hold -1: any distance (>= 0) keeps them below every valid point
  return sq3(x, y, z) > 1e-3f ? 1e10f : -1.0f;
}

// Order-preserving key of a float (the kernel sees no -0.0 and no NaN).
__device__ __forceinline__ unsigned ord_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Whole-warp argmax: every lane ends with the candidate of largest value,
// the lowest index among equal values.
__device__ __forceinline__ void warp_argmax(Cand& c) {
  const unsigned key = ord_key(c.v);
  const unsigned kmax = __reduce_max_sync(kFull, key);
  const unsigned imin =
      __reduce_min_sync(kFull, key == kmax ? static_cast<unsigned>(c.i) : 0xffffffffu);
  const int src =
      __ffs(__ballot_sync(kFull, key == kmax && static_cast<unsigned>(c.i) == imin)) - 1;
  c = {__shfl_sync(kFull, c.v, src), __shfl_sync(kFull, c.i, src), __shfl_sync(kFull, c.x, src),
       __shfl_sync(kFull, c.y, src), __shfl_sync(kFull, c.z, src)};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Arrive, with release at cluster scope, on the mbarrier at the same
// shared-memory offset as `bar` in block `rank` of the cluster.
__device__ __forceinline__ void remote_arrive(const void* bar, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" :: "r"(remote)
               : "memory");
}

// Waits, with acquire at cluster scope, until the phase of `bar` with this
// parity has completed.
__device__ __forceinline__ void wait_phase(const void* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

template <int kThreads, int kPPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, float* __restrict__ mind,
                   int* __restrict__ out, int n, int npoint, int share) {
  static_assert(kPPT > 0 || kPPT == kShared || kPPT == kGlobal, "unknown variant");
  constexpr int kWarps = kThreads / 32;
  constexpr int kRegs = kPPT > 0 ? kPPT : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int scene = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(scene) * n * 3;
  float* md = mind + static_cast<size_t>(scene) * n;  // kGlobal only
  int* o = out + static_cast<size_t>(scene) * npoint;
  const int lo = rank * share;
  const int len = max(0, min(share, n - lo));
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const Cand pad = {-INFINITY, INT_MAX, 0.0f, 0.0f, 0.0f};

  __shared__ Cand s_slot[2][kMaxCluster];
  __shared__ Cand s_warp[kWarps];
  __shared__ unsigned long long s_full[2];  // mbarriers: all S candidates of a step are in
  if (t == 0) {
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(&s_full[k])),
                   "r"(csize));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  extern __shared__ float4 s_pts[];  // kShared: (x, y, z, min distance) a point

  float rx[kRegs], ry[kRegs], rz[kRegs], rm[kRegs];
  if constexpr (kPPT > 0) {
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int q = t + k * kThreads;
      if (q < len) {
        const int g = lo + q;
        rx[k] = p[3 * g];
        ry[k] = p[3 * g + 1];
        rz[k] = p[3 * g + 2];
        rm[k] = init_dist(rx[k], ry[k], rz[k]);
      } else {  // padding: fminf keeps -inf, which never beats a candidate
        rx[k] = ry[k] = rz[k] = 0.0f;
        rm[k] = -INFINITY;
      }
    }
  } else {
    for (int q = t; q < len; q += kThreads) {
      const int g = lo + q;
      const float x = p[3 * g], y = p[3 * g + 1], z = p[3 * g + 2];
      if constexpr (kPPT == kShared) {
        s_pts[q] = make_float4(x, y, z, init_dist(x, y, z));
      } else {
        md[g] = init_dist(x, y, z);  // read back only by this thread
      }
    }
  }
  if (rank == 0 && t == 0) o[0] = 0;
  float px = p[0], py = p[1], pz = p[2];
  cluster.sync();  // every block has started, filled its share and set up its barriers

  for (int j = 1; j < npoint; ++j) {
    Cand c = pad;
    if constexpr (kPPT > 0) {
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const float d = sq3(__fsub_rn(rx[k], px), __fsub_rn(ry[k], py), __fsub_rn(rz[k], pz));
        const float m = fminf(rm[k], d);
        rm[k] = m;
        if (m > c.v) {  // k rises with the index, so a thread keeps its first maximum
          c = {m, lo + t + k * kThreads, rx[k], ry[k], rz[k]};
        }
      }
    } else {
      for (int q = t; q < len; q += kThreads) {
        const int g = lo + q;
        float x, y, z, m;
        if constexpr (kPPT == kShared) {
          const float4 s = s_pts[q];
          x = s.x, y = s.y, z = s.z;
          m = fminf(s.w, sq3(__fsub_rn(x, px), __fsub_rn(y, py), __fsub_rn(z, pz)));
          s_pts[q].w = m;
        } else {
          x = p[3 * g], y = p[3 * g + 1], z = p[3 * g + 2];
          m = fminf(md[g], sq3(__fsub_rn(x, px), __fsub_rn(y, py), __fsub_rn(z, pz)));
          md[g] = m;
        }
        if (m > c.v) c = {m, g, x, y, z};
      }
    }
    warp_argmax(c);
    if (lane == 0) s_warp[warp] = c;
    __syncthreads();
    const int buf = j & 1;
    if (warp == 0) {
      c = s_warp[lane & (kWarps - 1)];
      warp_argmax(c);
      if (lane < csize) {
        *cluster.map_shared_rank(&s_slot[buf][rank], lane) = c;
        remote_arrive(&s_full[buf], lane);
      }
    }
    wait_phase(&s_full[buf], ((j - 1) >> 1) & 1);
    const int r = lane & (kMaxCluster - 1);
    c = r < csize ? s_slot[buf][r] : pad;
    warp_argmax(c);
    px = c.x, py = c.y, pz = c.z;
    if (rank == 0 && t == 0) o[j] = c.i;
  }
  cluster.sync();
}

constexpr int kSharedMaxPoints = 14336;  // 224 KiB of (x, y, z, min distance)

template <int kThreads, int kPPT>
struct Variant {
  static int dyn_smem(int share) { return kPPT == kShared ? share * 16 : 0; }

  static cudaError_t config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int blocks,
                            int cluster, int share, cudaStream_t stream) {
    static bool ready = false;
    if (!ready) {
      cudaError_t e = cudaFuncSetAttribute(fps_cluster_kernel<kThreads, kPPT>,
                                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e == cudaSuccess && kPPT == kShared) {
        e = cudaFuncSetAttribute(fps_cluster_kernel<kThreads, kPPT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSharedMaxPoints * 16);
      }
      if (e != cudaSuccess) return e;
      ready = true;
    }
    if (cluster < 1 || cluster > kMaxCluster || share < 1 ||
        (kPPT > 0 && share > kPPT * kThreads) || (kPPT == kShared && share > kSharedMaxPoints)) {
      return cudaErrorInvalidValue;
    }
    cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = dyn_smem(share);
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
  }

  static int launch(const float* xyz, float* mind, int* out, int b, int n, int npoint,
                    int cluster, int share, cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = config(cfg, attr, b * cluster, cluster, share, stream);
    if (e == cudaSuccess) {
      e = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<kThreads, kPPT>, xyz, mind, out, n,
                             npoint, share);
    }
    return e != cudaSuccess ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
  }

  static int max_active_clusters(int cluster, int share, int* count) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = config(cfg, attr, cluster, cluster, share, nullptr);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveClusters(count, fps_cluster_kernel<kThreads, kPPT>, &cfg);
    }
    return static_cast<int>(e);
  }
};

// The instantiated (threads, points a thread) pairs of the register variant
// must match ops/fps.py's REG_PPTS: 128 and 256 threads for the launch rule,
// 512 and 1024 threads only for the sweep at the serving shape. Shared and
// global variants run at 1024 threads.
#define FPS_VARIANTS(X)                                                  \
  X(128, 2) X(128, 5) X(128, 10) X(128, 20) X(128, 40)                   \
  X(256, 2) X(256, 5) X(256, 10) X(256, 20) X(256, 40)                   \
  X(512, 5) X(512, 10) X(1024, 3) X(1024, 5)                             \
  X(1024, 0) X(1024, -1)

}  // namespace

// xyz: (b, n, 3) f32; mind: (b, n) f32 scratch, read only when ppt == -1;
// out: (b, npoint) i32. One cluster of `cluster` blocks of `threads` threads
// per scene, each block owning `share` points. ppt > 0 keeps a thread's
// points in registers, 0 the block's share in shared memory, -1 streams it
// from global memory. An uninstantiated (threads, ppt) returns
// cudaErrorInvalidValue.
extern "C" int fps_launch(const float* xyz, float* mind, int* out, int b, int n, int npoint,
                          int cluster, int threads, int ppt, int share, cudaStream_t stream) {
#define FPS_LAUNCH(T, P) \
  if (threads == T && ppt == P)  \
    return Variant<T, P>::launch(xyz, mind, out, b, n, npoint, cluster, share, stream);
  FPS_VARIANTS(FPS_LAUNCH)
#undef FPS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaOccupancyMaxActiveClusters for the same launch: how many clusters of
// this variant the card holds at once.
extern "C" int fps_max_active_clusters(int cluster, int threads, int ppt, int share,
                                       int* count) {
#define FPS_QUERY(T, P) \
  if (threads == T && ppt == P) return Variant<T, P>::max_active_clusters(cluster, share, count);
  FPS_VARIANTS(FPS_QUERY)
#undef FPS_QUERY
  return static_cast<int>(cudaErrorInvalidValue);
}
