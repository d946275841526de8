// Rotated box overlap and IoU of paired rows: for each scene b, every box k
// of boxes_a[b] against every box g of boxes_b[b].
//
// Replaces the XLA program iou3dmatch_tpu/geometry/iou3d.py::_pair_overlap_bev
// (vmapped over pairs by boxes_iou3d_paired_rows, boxes_iou3d, boxes_overlap_bev
// and boxes_iou_bev), itself a rebuild of OpenPCDet's box_overlap
// (iou3d_nms_kernel.cu:105-227). The pretrain step runs it twice, for the IoU
// labels of the proposals and of their jittered copies: (8, 128, 7) x
// (8, 64, 7) boxes.
//
// What bounds it on the H100: at the step's shapes, neither bytes (60 KB)
// nor operations: a launch and one pair's chain of dependent steps. Only a
// few pairs can overlap (1,125 of 65,536 at chip_smoke.py's input), so the work
// is to reject the rest cheaply and to cut each remaining pair's chain:
//
// - A block owns kTileA rows of boxes_a x kTileB columns of boxes_b of one
//   scene (blocks are 1-D over scene x row tiles x column tiles). Each box
//   is prepared once, in shared memory: its corners, cos and sin of -h, its
//   corners' x and y extents grown by half the reach, its z range, area and
//   volume.
// - Reject: a pair whose grown x or y extents do not meet has no candidate
//   vertex, and in mode 1 a pair whose z ranges do not overlap has a zero
//   intersection, so the full computation gives exactly 0 there; it is
//   written 0 and never computed. No corner lies in the other box's 1e-2
//   margin past an x or y gap of sqrt(2) x 1e-2, and edges meet only where
//   the corners' extents do; the reach, 1.5e-2 plus 1e-5 of the boxes'
//   coordinates, covers that and the rounding (geometry/iou3d.py::pairs_apart
//   is the same rule in PyTorch, which the CPU tests hold against the
//   candidates).
// - The pairs that remain go onto a shared worklist (a warp ballot and one
//   counter add a warp); each is computed by one warp: lanes 0-15 intersect
//   edge lane/4 of A with edge lane%4 of B, lanes 16-23 test corner k of B
//   in A (16 + 2k) and corner k of A in B (17 + 2k), the JAX candidate
//   order; the centroid is a warp sum over the valid candidates, each lane
//   takes its candidate's angle with atan2f, and its rank among the valid
//   ones (a smaller angle, or an equal one and a lower index: the stable
//   sort of the plain version) by shuffles; the ranked vertices go through
//   shared memory, and the fan terms are summed by a warp reduction.
//
// Exactness against the plain PyTorch version (geometry/iou3d.py), which
// follows the JAX code step by step: the candidates, corners and tests are
// computed as there, every product and sum rounded on its own (this file is
// built with -fmad=false, see ops/_build.py), the angles come from atan2f,
// and tied angles keep candidate order, as coinciding candidates of
// axis-aligned boxes need. The centroid and the area are summed in another
// order than PyTorch's, so the two agree to rounding (the card check allows
// atol 1e-5). Degenerate edges take the general line-line form as the JAX
// code does; a pair with no valid candidate has overlap 0; placeholder
// boxes at -1000 overlap nothing.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileA = 2;  // few rows a block: the pairs left cluster on a scene's first rows
constexpr int kTileB = 128;
constexpr int kPairs = kTileA * kTileB;
constexpr float kEps = 1e-8f;
constexpr float kMargin = 1e-2f;
constexpr float kHalfReach = 7.5e-3f;  // each box's share of the 1.5e-2 reach
constexpr float kRelReach = 1e-5f;     // and of the rounding, by its coordinates

struct Prep {
  float x, y, hxm, hym;      // center; half sizes plus the containment margin
  float c, s;                // cos(-h), sin(-h): into the box's frame
  float cx[4], cy[4];        // corners
  float lox, loy, hix, hiy;  // the corners' extents, grown by the box's reach
  float zmax, zmin, area, vol;
};

// corners in the order of iou3d_nms_kernel.cu:127-134, rotated about the center
__device__ void prepare(const float* p, Prep& q) {
  const float x = p[0], y = p[1], z = p[2], dx = p[3], dy = p[4], dz = p[5], h = p[6];
  const float sx[4] = {-1.f, 1.f, 1.f, -1.f};
  const float sy[4] = {-1.f, -1.f, 1.f, 1.f};
  const float hx = dx * 0.5f, hy = dy * 0.5f;
  const float c = cosf(h), s = sinf(h);
  float lox = 0.f, loy = 0.f, hix = 0.f, hiy = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lx = sx[i] * hx, ly = sy[i] * hy;
    const float px = lx * c - ly * s + x;
    const float py = lx * s + ly * c + y;
    q.cx[i] = px;
    q.cy[i] = py;
    // from corner 0, so that a NaN box has NaN extents and is never rejected
    lox = i ? fminf(lox, px) : px;
    hix = i ? fmaxf(hix, px) : px;
    loy = i ? fminf(loy, py) : py;
    hiy = i ? fmaxf(hiy, py) : py;
  }
  const float reach = kHalfReach + kRelReach * (fabsf(x) + fabsf(y) + fabsf(dx) + fabsf(dy));
  q.lox = lox - reach;
  q.hix = hix + reach;
  q.loy = loy - reach;
  q.hiy = hiy + reach;
  q.x = x;
  q.y = y;
  q.hxm = hx + kMargin;
  q.hym = hy + kMargin;
  q.c = cosf(-h);
  q.s = sinf(-h);
  q.zmax = z + dz * 0.5f;
  q.zmin = z - dz * 0.5f;
  q.area = dx * dy;
  q.vol = q.area * dz;
}

__device__ __forceinline__ bool apart(const Prep& a, const Prep& b, int mode) {
  if (a.hix < b.lox || b.hix < a.lox || a.hiy < b.loy || b.hiy < a.loy) return true;
  return mode == 1 && fminf(a.zmax, b.zmax) - fmaxf(a.zmin, b.zmin) <= 0.f;
}

__device__ __forceinline__ float cross2(float ox, float oy, float ax, float ay, float bx, float by) {
  return (ax - ox) * (by - oy) - (bx - ox) * (ay - oy);
}

// segment p0-p1 against q0-q1 (iou3d.py::_seg_intersection)
__device__ __forceinline__ bool intersection(float p0x, float p0y, float p1x, float p1y, float q0x,
                                             float q0y, float q1x, float q1y, float& x, float& y) {
  const bool rect = fminf(p0x, p1x) <= fmaxf(q0x, q1x) && fminf(q0x, q1x) <= fmaxf(p0x, p1x) &&
                    fminf(p0y, p1y) <= fmaxf(q0y, q1y) && fminf(q0y, q1y) <= fmaxf(p0y, p1y);
  const float s1 = cross2(p0x, p0y, q0x, q0y, p1x, p1y);
  const float s2 = cross2(p0x, p0y, p1x, p1y, q1x, q1y);
  const float s3 = cross2(q0x, q0y, p0x, p0y, q1x, q1y);
  const float s4 = cross2(q0x, q0y, q1x, q1y, p1x, p1y);
  const bool valid = rect && s1 * s2 > 0.f && s3 * s4 > 0.f;
  const float s5 = cross2(p0x, p0y, q1x, q1y, p1x, p1y);
  const float denom = s5 - s1;
  if (fabsf(denom) > kEps) {
    x = (s5 * q0x - s1 * q1x) / denom;
    y = (s5 * q0y - s1 * q1y) / denom;
  } else {  // the general line-line form (iou3d.py:69-79)
    const float a0 = p0y - p1y, b0 = p1x - p0x, c0 = p0x * p1y - p1x * p0y;
    const float a1 = q0y - q1y, b1 = q1x - q0x, c1 = q0x * q1y - q1x * q0y;
    const float d = a0 * b1 - a1 * b0;
    const float ds = fabsf(d) > 0.f ? d : 1.f;
    x = (b0 * c1 - b1 * c0) / ds;
    y = (a1 * c0 - a0 * c1) / ds;
  }
  return valid;
}

// point inside the box, with the 1e-2 margin (iou3d.py::_check_in_box2d)
__device__ __forceinline__ bool in_box(const Prep& b, float px, float py) {
  const float dx = px - b.x, dy = py - b.y;
  const float rx = dx * b.c - dy * b.s;
  const float ry = dx * b.s + dy * b.c;
  return fabsf(rx) < b.hxm && fabsf(ry) < b.hym;
}

// A butterfly: every lane adds the same pairs, so every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The BEV overlap of one pair, computed by the whole warp; buf holds 48
// floats of the warp's own.
__device__ float overlap_bev(const Prep& a, const Prep& b, int lane, float* buf) {
  float px = 0.f, py = 0.f;
  bool valid = false;
  if (lane < 16) {
    const int i = lane >> 2, j = lane & 3;
    const int i1 = (i + 1) & 3, j1 = (j + 1) & 3;
    valid = intersection(a.cx[i], a.cy[i], a.cx[i1], a.cy[i1], b.cx[j], b.cy[j], b.cx[j1], b.cy[j1],
                         px, py);
  } else if (lane < 24) {
    const int k = (lane - 16) >> 1;
    const Prep& box = lane & 1 ? b : a;     // the box tested against
    const Prep& other = lane & 1 ? a : b;   // the box whose corner k is tested
    px = other.cx[k];
    py = other.cy[k];
    valid = in_box(box, px, py);
  }
  const int cnt = __popc(__ballot_sync(0xffffffffu, valid));
  if (cnt == 0) return 0.f;

  // centroid: every candidate times its 0/1 validity, as the JAX sum does
  const float vf = valid ? 1.f : 0.f;
  const float cx = warp_sum(px * vf) / static_cast<float>(cnt);
  const float cy = warp_sum(py * vf) / static_cast<float>(cnt);
  const float ang = valid ? atan2f(py - cy, px - cx) : CUDART_INF_F;
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const float aj = __shfl_sync(0xffffffffu, ang, j);
    rank += aj < ang || (aj == ang && j < lane);
  }
  if (valid) {
    buf[rank] = px;
    buf[24 + rank] = py;
  }
  __syncwarp();
  // fan triangulation from the first sorted vertex: the term of ranks r, r + 1
  float term = 0.f;
  if (lane + 1 < cnt) {
    const float vx0 = buf[lane] - buf[0], vy0 = buf[24 + lane] - buf[24];
    const float vx1 = buf[lane + 1] - buf[0], vy1 = buf[25 + lane] - buf[24];
    term = vx0 * vy1 - vx1 * vy0;
  }
  __syncwarp();
  return fabsf(warp_sum(term)) * 0.5f;
}

__global__ void __launch_bounds__(kThreads)
iou3d_kernel(const float* __restrict__ boxes_a, const float* __restrict__ boxes_b,
             float* __restrict__ out, int k, int g, int mode, int tiles_k, int tiles_g) {
  __shared__ Prep pa[kTileA];
  __shared__ Prep pb[kTileB];
  __shared__ int list[kPairs];  // i * kTileB + j of the pairs left to compute
  __shared__ int count;
  __shared__ float buf[kWarps][48];

  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int tg = static_cast<int>(blockIdx.x % tiles_g);
  const int tk = static_cast<int>(blockIdx.x / tiles_g % tiles_k);
  const long long b = blockIdx.x / tiles_g / tiles_k;
  const int k0 = tk * kTileA, g0 = tg * kTileB;
  const int nk = min(kTileA, k - k0), ng = min(kTileB, g - g0);
  if (tid < nk) {
    prepare(boxes_a + (b * k + k0 + tid) * 7, pa[tid]);
  } else if (tid >= kTileA && tid - kTileA < ng) {
    prepare(boxes_b + (b * g + g0 + tid - kTileA) * 7, pb[tid - kTileA]);
  }
  if (tid == 0) count = 0;
  __syncthreads();

  float* o = out + (b * k + k0) * g + g0;
  for (int p = tid; p < kPairs; p += kThreads) {  // the same trip count on every thread
    const int i = p / kTileB, j = p % kTileB;
    bool left = false;
    if (i < nk && j < ng) {
      if (apart(pa[i], pb[j], mode)) {
        o[static_cast<long long>(i) * g + j] = 0.f;
      } else {
        left = true;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, left);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&count, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (left) list[base + __popc(m & ((1u << lane) - 1u))] = p;
  }
  __syncthreads();

  const int pairs = count;
  for (int e = warp; e < pairs; e += kWarps) {
    const int p = list[e];
    const int i = p / kTileB, j = p % kTileB;
    const Prep& a = pa[i];
    const Prep& q = pb[j];
    const float overlap = overlap_bev(a, q, lane, buf[warp]);
    if (lane == 0) {
      float r = overlap;
      if (mode == 1) {  // 3D IoU: BEV overlap x z overlap / union
        const float h = fmaxf(fminf(a.zmax, q.zmax) - fmaxf(a.zmin, q.zmin), 0.f);
        const float inter = overlap * h;
        r = inter / fmaxf(a.vol + q.vol - inter, 1e-6f);
      } else if (mode == 2) {  // BEV IoU
        r = overlap / fmaxf(a.area + q.area - overlap, 1e-6f);
      }
      o[static_cast<long long>(i) * g + j] = r;
    }
  }
}

}  // namespace

// boxes_a: (b, k, 7) f32; boxes_b: (b, g, 7) f32; out: (b, k, g) f32.
// mode 0: BEV overlap, 1: 3D IoU, 2: BEV IoU.
extern "C" int iou3d_launch(const float* boxes_a, const float* boxes_b, float* out, int b, int k,
                            int g, int mode, cudaStream_t stream) {
  if (b < 1 || k < 1 || g < 1 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_k = (k + kTileA - 1) / kTileA, tiles_g = (g + kTileB - 1) / kTileB;
  const long long blocks = static_cast<long long>(b) * tiles_k * tiles_g;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  iou3d_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(boxes_a, boxes_b, out, k, g,
                                                                       mode, tiles_k, tiles_g);
  return static_cast<int>(cudaGetLastError());
}
