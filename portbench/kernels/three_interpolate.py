"""``three_interpolate``'s forward (``csrc/three_interpolate.cu``) as FP
runs it: the indices and weights read once, the (n, c) interpolated rows
and the (n, skip) skip rows written once and the skip rows read once; 6
operations an output element. The feature rows read depend on the indices
and are left out of this lower bound."""
PATTERN = r"\bthree_interpolate_kernel\b"
OPS = 3 + 3


def bound_s(s: dict, peak: dict) -> float:
    b, n, c = s["b"], s["n"], s["c"]
    nbytes = 2 * b * n * 3 * 4 + b * n * c * 4 + 2 * b * n * s.get("skip", 0) * 4
    return max(nbytes / peak["hbm_bytes_per_s"], b * n * c * OPS / peak["issue_ops_per_s"])
