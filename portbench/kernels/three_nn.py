"""``three_nn`` (``csrc/three_nn.cu``): each of n queries tests every one
of m seeds (9 operations) and computes its 3 picks again with their square
roots (about a test each); queries and seeds read once, 3 distances and 3
indices written a query (``chip_smoke.py::three_nn_rows``)."""
PATTERN = r"\bthree_nn_kernel\b"
PAIR_OPS = 9


def bound_s(s: dict, peak: dict) -> float:
    b, n, m = s["b"], s["n"], s["m"]
    nbytes = (b * n * 3 + b * m * 3) * 4 + b * n * 3 * (4 + 4)
    ops = b * n * (m + 3) * PAIR_OPS
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["issue_ops_per_s"])
