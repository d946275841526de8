// Host-side oriented 3D box IoU — C++ runtime for the VOC AP evaluator.
// The port's copy of iou3dmatch_tpu/native/iou3d_host.cc.
//
// Exact same algorithm as eval/box3d_iou_np.py (Sutherland–Hodgman clip of
// the two BEV rectangles, shoelace area, y-extent overlap), which mirrors
// the reference utils/box_util.py:23-137. The reference needed a 10-process
// pool to make scipy ConvexHull per-pair tolerable (utils/eval_det.py:215);
// this native path evaluates whole IoU matrices in-process.
//
// Built by native/__init__.py: g++ -O3 -shared -fPIC into build/native/.
#include <cmath>
#include <cstddef>

namespace {

struct P2 {
  double x, y;
};

inline bool inside(const P2& p, const P2& cp1, const P2& cp2) {
  // strict '>' like box_util.py:31 / box3d_iou_np.py:16
  return (cp2.x - cp1.x) * (p.y - cp1.y) > (cp2.y - cp1.y) * (p.x - cp1.x);
}

inline P2 intersection(const P2& cp1, const P2& cp2, const P2& s, const P2& e) {
  const double dcx = cp1.x - cp2.x, dcy = cp1.y - cp2.y;
  const double dpx = s.x - e.x, dpy = s.y - e.y;
  const double n1 = cp1.x * cp2.y - cp1.y * cp2.x;
  const double n2 = s.x * e.y - s.y * e.x;
  const double n3 = 1.0 / (dcx * dpy - dcy * dpx);
  return P2{(n1 * dpx - n2 * dcx) * n3, (n1 * dpy - n2 * dcy) * n3};
}

// Sutherland–Hodgman: clip `subj` (n vertices) by convex quad `clip`.
// Returns vertex count (0 when empty). Max output vertices for two quads: 8.
int polygon_clip(const P2* subj, int n, const P2 clip[4], P2* out) {
  P2 buf_a[16], buf_b[16];
  int na = n;
  for (int i = 0; i < n; ++i) buf_a[i] = subj[i];
  P2* inp = buf_a;
  P2* outp = buf_b;
  P2 cp1 = clip[3];
  for (int c = 0; c < 4; ++c) {
    const P2 cp2 = clip[c];
    int no = 0;
    if (na == 0) return 0;
    P2 s = inp[na - 1];
    for (int i = 0; i < na; ++i) {
      const P2 e = inp[i];
      if (inside(e, cp1, cp2)) {
        if (!inside(s, cp1, cp2)) outp[no++] = intersection(cp1, cp2, s, e);
        outp[no++] = e;
      } else if (inside(s, cp1, cp2)) {
        outp[no++] = intersection(cp1, cp2, s, e);
      }
      s = e;
    }
    cp1 = cp2;
    na = no;
    P2* t = inp; inp = outp; outp = t;
  }
  for (int i = 0; i < na; ++i) out[i] = inp[i];
  return na;
}

double poly_area(const P2* p, int n) {
  // shoelace with roll(,1): sum x[i]*y[i-1] - y[i]*x[i-1]
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + n - 1) % n;
    s += p[i].x * p[j].y - p[i].y * p[j].x;
  }
  return 0.5 * std::fabs(s);
}

inline double dist3(const float* a, const float* b) {
  const double dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return std::sqrt(dx * dx + dy * dy + dz * dz);
}

// corners: (8, 3) row-major, camera-frame (y up-negative layout identical to
// box_util.get_3d_box: 0-3 top face, 4-7 bottom face).
double box3d_vol(const float* c) {
  return dist3(c, c + 3) * dist3(c + 3, c + 6) * dist3(c, c + 12);
}

}  // namespace

extern "C" {

// corners1/corners2: (8, 3) float32. Returns IoU3D; *iou_bev gets BEV IoU.
float box3d_iou_pair(const float* c1, const float* c2, float* iou_bev) {
  // BEV rect from corners[3..0], coords (x, z) — box3d_iou_np.py:62-63
  P2 r1[4], r2[4];
  for (int i = 0; i < 4; ++i) {
    const int k = 3 - i;
    r1[i] = P2{c1[k * 3 + 0], c1[k * 3 + 2]};
    r2[i] = P2{c2[k * 3 + 0], c2[k * 3 + 2]};
  }
  const double area1 = poly_area(r1, 4);
  const double area2 = poly_area(r2, 4);
  P2 inter[16];
  const int ni = polygon_clip(r1, 4, r2, inter);
  const double inter_area = ni > 0 ? poly_area(inter, ni) : 0.0;
  const double bev = inter_area / (area1 + area2 - inter_area);
  if (iou_bev) *iou_bev = static_cast<float>(bev);
  const double ymax =
      c1[0 * 3 + 1] < c2[0 * 3 + 1] ? c1[0 * 3 + 1] : c2[0 * 3 + 1];
  const double ymin =
      c1[4 * 3 + 1] > c2[4 * 3 + 1] ? c1[4 * 3 + 1] : c2[4 * 3 + 1];
  const double h = ymax - ymin > 0.0 ? ymax - ymin : 0.0;
  const double inter_vol = inter_area * h;
  const double v1 = box3d_vol(c1);
  const double v2 = box3d_vol(c2);
  return static_cast<float>(inter_vol / (v1 + v2 - inter_vol));
}

// a: (na, 8, 3), b: (nb, 8, 3) -> out: (na, nb) IoU3D.
void box3d_iou_matrix(const float* a, int na, const float* b, int nb,
                      float* out) {
  for (int i = 0; i < na; ++i)
    for (int j = 0; j < nb; ++j)
      out[i * nb + j] = box3d_iou_pair(a + i * 24, b + j * 24, nullptr);
}

}  // extern "C"
