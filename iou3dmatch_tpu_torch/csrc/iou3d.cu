// Rotated box overlap and IoU of paired rows: for each scene b, every box k
// of boxes_a[b] against every box g of boxes_b[b], one thread a pair.
//
// Replaces the XLA program iou3dmatch_tpu/geometry/iou3d.py::_pair_overlap_bev
// (vmapped over pairs by boxes_iou3d_paired_rows, boxes_iou3d, boxes_overlap_bev
// and boxes_iou_bev), itself a rebuild of OpenPCDet's box_overlap
// (iou3d_nms_kernel.cu:105-227). The pretrain step runs it twice, for the IoU
// labels of the proposals and of their jittered copies: (8, 128, 7) x
// (8, 64, 7) boxes.
//
// What bounds it on the H100: operations. A pair reads 56 bytes that are
// shared with its row and column and writes 4, but computes 16 edge-edge
// intersections, 8 containment tests, 24 angles, a sort and a fan area:
// some 2,000 operations. The design keeps a pair in one thread and its 24
// candidate vertices in the thread's arrays; neither the bound nor a first
// version asks for more.
//
// Exactness against the plain PyTorch version (geometry/iou3d.py), which
// follows the JAX code step by step: the candidates are made in the JAX
// order, every product and sum is rounded on its own (this file is built
// with -fmad=false, see ops/_build.py), the angles come from atan2f, and the
// sort is a stable insertion sort of the valid candidates, which orders them
// as the JAX stable sort with invalid candidates last does. ScanNet boxes
// are axis-aligned, so candidates that coincide tie in angle; the stable sort
// keeps their candidate order. The sums over candidates run in index order
// here and in PyTorch's reduction order there, so the two agree to rounding
// (the card check allows atol 1e-5). Degenerate edges take the general
// line-line form as the JAX code does; a pair with no valid candidate has
// overlap 0; placeholder boxes at -1000 overlap nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-8f;
constexpr float kMargin = 1e-2f;

struct Box {
  float x, y, z, dx, dy, dz, h;
};

__device__ __forceinline__ Box load_box(const float* p) {
  return Box{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
}

// corner order of iou3d_nms_kernel.cu:127-134, rotated about the center
__device__ __forceinline__ void corners(const Box& b, float* cx, float* cy) {
  const float sx[4] = {-1.f, 1.f, 1.f, -1.f};
  const float sy[4] = {-1.f, -1.f, 1.f, 1.f};
  const float hx = b.dx * 0.5f, hy = b.dy * 0.5f;
  const float c = cosf(b.h), s = sinf(b.h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lx = sx[i] * hx, ly = sy[i] * hy;
    cx[i] = lx * c - ly * s + b.x;
    cy[i] = lx * s + ly * c + b.y;
  }
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
__device__ __forceinline__ bool in_box(const Box& b, float c, float s, float px, float py) {
  const float dx = px - b.x, dy = py - b.y;
  const float rx = dx * c - dy * s;
  const float ry = dx * s + dy * c;
  return fabsf(rx) < b.dx * 0.5f + kMargin && fabsf(ry) < b.dy * 0.5f + kMargin;
}

__device__ float overlap_bev(const Box& a, const Box& b) {
  float ax[5], ay[5], bx[5], by[5];
  corners(a, ax, ay);
  corners(b, bx, by);
  ax[4] = ax[0];
  ay[4] = ay[0];
  bx[4] = bx[0];
  by[4] = by[0];

  float px[24], py[24];
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = i * 4 + j;
      if (intersection(ax[i], ay[i], ax[i + 1], ay[i + 1], bx[j], by[j], bx[j + 1], by[j + 1],
                       px[k], py[k])) {
        valid |= 1u << k;
      }
    }
  }
  const float ca = cosf(-a.h), sa = sinf(-a.h), cb = cosf(-b.h), sb = sinf(-b.h);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[16 + 2 * k] = bx[k];
    py[16 + 2 * k] = by[k];
    if (in_box(a, ca, sa, bx[k], by[k])) valid |= 1u << (16 + 2 * k);
    px[17 + 2 * k] = ax[k];
    py[17 + 2 * k] = ay[k];
    if (in_box(b, cb, sb, ax[k], ay[k])) valid |= 1u << (17 + 2 * k);
  }
  const int cnt = __popc(valid);
  if (cnt == 0) return 0.f;

  // centroid: every candidate times its 0/1 validity, as the JAX sum does
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int k = 0; k < 24; ++k) {
    const float vf = (valid >> k) & 1u ? 1.f : 0.f;
    sx += px[k] * vf;
    sy += py[k] * vf;
  }
  const float cx = sx / static_cast<float>(cnt), cy = sy / static_cast<float>(cnt);

  // the valid candidates in candidate order, then a stable insertion sort
  // by angle: the order of a stable sort of all 24 with invalid ones last
  float ang[24], qx[24], qy[24];
  int n = 0;
#pragma unroll
  for (int k = 0; k < 24; ++k) {
    if ((valid >> k) & 1u) {
      ang[n] = atan2f(py[k] - cy, px[k] - cx);
      qx[n] = px[k];
      qy[n] = py[k];
      ++n;
    }
  }
  for (int i = 1; i < n; ++i) {
    const float ka = ang[i], kx = qx[i], ky = qy[i];
    int j = i - 1;
    while (j >= 0 && ang[j] > ka) {
      ang[j + 1] = ang[j];
      qx[j + 1] = qx[j];
      qy[j + 1] = qy[j];
      --j;
    }
    ang[j + 1] = ka;
    qx[j + 1] = kx;
    qy[j + 1] = ky;
  }

  // fan triangulation from the first sorted vertex
  float area = 0.f;
  float vx0 = 0.f, vy0 = 0.f;
  for (int k = 1; k < n; ++k) {
    const float vx1 = qx[k] - qx[0], vy1 = qy[k] - qy[0];
    area += vx0 * vy1 - vx1 * vy0;
    vx0 = vx1;
    vy0 = vy1;
  }
  return fabsf(area) * 0.5f;
}

__global__ void __launch_bounds__(kThreads)
iou3d_kernel(const float* __restrict__ boxes_a, const float* __restrict__ boxes_b,
             float* __restrict__ out, int k, int g, int mode, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long row = t / g;  // b * k + i
  const long long b = row / k;
  const int j = static_cast<int>(t - row * g);
  const Box a = load_box(boxes_a + row * 7);
  const Box q = load_box(boxes_b + (b * g + j) * 7);
  const float overlap = overlap_bev(a, q);
  float r = overlap;
  if (mode == 1) {  // 3D IoU: BEV overlap x z overlap / union
    const float a_zmax = a.z + a.dz * 0.5f, a_zmin = a.z - a.dz * 0.5f;
    const float b_zmax = q.z + q.dz * 0.5f, b_zmin = q.z - q.dz * 0.5f;
    const float h = fmaxf(fminf(a_zmax, b_zmax) - fmaxf(a_zmin, b_zmin), 0.f);
    const float inter = overlap * h;
    const float vol_a = a.dx * a.dy * a.dz, vol_b = q.dx * q.dy * q.dz;
    r = inter / fmaxf(vol_a + vol_b - inter, 1e-6f);
  } else if (mode == 2) {  // BEV IoU
    r = overlap / fmaxf(a.dx * a.dy + q.dx * q.dy - overlap, 1e-6f);
  }
  out[t] = r;
}

}  // namespace

// boxes_a: (b, k, 7) f32; boxes_b: (b, g, 7) f32; out: (b, k, g) f32.
// mode 0: BEV overlap, 1: 3D IoU, 2: BEV IoU.
extern "C" int iou3d_launch(const float* boxes_a, const float* boxes_b, float* out, int b, int k,
                            int g, int mode, cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * k * g;
  const long long blocks = (total + kThreads - 1) / kThreads;
  iou3d_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(boxes_a, boxes_b, out, k,
                                                                       g, mode, total);
  return static_cast<int>(cudaGetLastError());
}
