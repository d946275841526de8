"""``three_interpolate``'s backward (``csrc/three_interpolate.cu``): the
(n, c) cotangent, the indices and the weights read once, the (m, c) table
written once; a product and a sum a slot and a channel
(``chip_smoke.py::three_interpolate_rows``)."""
PATTERN = r"\bthree_interpolate_bwd_kernel\b"
OPS = 2


def bound_s(s: dict, peak: dict) -> float:
    b, n, m, c = s["b"], s["n"], s["m"], s["c"]
    nbytes = (b * n * c + 2 * b * n * 3 + b * m * c) * 4
    return max(nbytes / peak["hbm_bytes_per_s"], b * n * 3 * c * OPS / peak["issue_ops_per_s"])
