// Native host-side data-loader kernels (C++), bound via ctypes.
// The port's copy of iou3dmatch_tpu/native/loader_host.cc.
//
// These replace the two largest deterministic costs of a ScanNet scene load:
// the per-instance vote-label computation (reference:
// scannet/scannet_detection_dataset.py:182-193) and the 0.99-percentile
// floor-height selection (same file :121-131). All random draws stay in
// NumPy so the np.random stream, and so bit-for-bit dataset parity with the
// reference, is untouched; these kernels are pure functions of their inputs
// and produce bit-identical outputs to the NumPy forms they replace
// (tests/test_torch_native_loader.py).
//
// Built by native/loader.py: g++ -O3 -ffp-contract=off -shared -fPIC into
// build/native/. -ffp-contract=off keeps the compiler from fusing a*b+c
// into FMA, which would change the rounding vs NumPy's per-op float
// semantics.
#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

// Per-instance AABB-center votes. Semantics mirrored from the reference
// loop: groups are runs of equal instance ids (in any order), a group is
// "valid" iff the semantic label of its FIRST point (first occurrence in
// input order == the loop's ind[0]) is in valid_ids, the vote target is
// 0.5*(min+max) per axis over the group's points, and every point of a
// valid group votes center - xyz. min/max are order-independent and
// 0.5*(a+b) / (c - x) are single rounded ops, so this is bit-identical to
// the NumPy reduceat form in data/scannet.py::_compute_votes for both f32
// and f64 point clouds (votes are stored into a float64 output array; the
// f32 path upcasts the already-rounded f32 result, exactly like NumPy).
template <typename T>
void votes_impl(const T* xyz, int64_t n, const int64_t* ins,
                const int64_t* sem, const int64_t* valid_ids,
                int64_t n_valid, double* votes, double* mask) {
  std::unordered_map<int64_t, int32_t> slot;
  slot.reserve(256);
  std::vector<T> mn, mx;
  std::vector<uint8_t> valid;
  std::vector<int32_t> point_slot(static_cast<size_t>(n));
  mn.reserve(3 * 256);
  mx.reserve(3 * 256);
  for (int64_t i = 0; i < n; ++i) {
    auto it = slot.find(ins[i]);
    int32_t s;
    if (it == slot.end()) {
      s = static_cast<int32_t>(valid.size());
      slot.emplace(ins[i], s);
      bool ok = false;
      for (int64_t k = 0; k < n_valid; ++k) {
        if (sem[i] == valid_ids[k]) {
          ok = true;
          break;
        }
      }
      valid.push_back(ok ? 1 : 0);
      for (int d = 0; d < 3; ++d) {
        mn.push_back(xyz[i * 3 + d]);
        mx.push_back(xyz[i * 3 + d]);
      }
    } else {
      s = it->second;
      for (int d = 0; d < 3; ++d) {
        T v = xyz[i * 3 + d];
        if (v < mn[s * 3 + d]) mn[s * 3 + d] = v;
        if (v > mx[s * 3 + d]) mx[s * 3 + d] = v;
      }
    }
    point_slot[static_cast<size_t>(i)] = s;
  }
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = point_slot[static_cast<size_t>(i)];
    if (!valid[s]) continue;
    for (int d = 0; d < 3; ++d) {
      T c = T(0.5) * (mn[s * 3 + d] + mx[s * 3 + d]);
      votes[i * 3 + d] = static_cast<double>(c - xyz[i * 3 + d]);
    }
    mask[i] = 1.0;
  }
}

// Two order statistics (values at sorted positions lo <= hi) via
// nth_element — the selection NumPy's percentile does with introselect.
// Order statistics are exact input elements, so there is no rounding to
// match; the interpolation between them is mirrored on the Python side.
template <typename T>
void order2_impl(const T* z, int64_t n, int64_t lo, int64_t hi, T* out2) {
  std::vector<T> buf(z, z + n);
  std::nth_element(buf.begin(), buf.begin() + lo, buf.end());
  out2[0] = buf[static_cast<size_t>(lo)];
  if (hi == lo) {
    out2[1] = out2[0];
    return;
  }
  std::nth_element(buf.begin() + lo + 1, buf.begin() + hi, buf.end());
  out2[1] = buf[static_cast<size_t>(hi)];
}

}  // namespace

extern "C" {

void scannet_votes_f32(const float* xyz, int64_t n, const int64_t* ins,
                       const int64_t* sem, const int64_t* valid_ids,
                       int64_t n_valid, double* votes, double* mask) {
  votes_impl<float>(xyz, n, ins, sem, valid_ids, n_valid, votes, mask);
}

void scannet_votes_f64(const double* xyz, int64_t n, const int64_t* ins,
                       const int64_t* sem, const int64_t* valid_ids,
                       int64_t n_valid, double* votes, double* mask) {
  votes_impl<double>(xyz, n, ins, sem, valid_ids, n_valid, votes, mask);
}

void order2_f32(const float* z, int64_t n, int64_t lo, int64_t hi,
                float* out2) {
  order2_impl<float>(z, n, lo, hi, out2);
}

void order2_f64(const double* z, int64_t n, int64_t lo, int64_t hi,
                double* out2) {
  order2_impl<double>(z, n, lo, hi, out2);
}

}  // extern "C"
