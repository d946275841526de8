"""FPS (``csrc/fps.cu``): every point's running distance is updated at each
of npoint - 1 steps, 9 operations (3 sub, 3 mul, 2 add, 1 min); the cloud is
read once and the indices written once (``chip_smoke.py::fps_rows``)."""
PATTERN = r"\bfps_cluster_kernel\b"
PAIR_OPS = 9


def bound_s(s: dict, peak: dict) -> float:
    nbytes = s["b"] * s["n"] * 12 + s["b"] * s["npoint"] * 4
    ops = (s["npoint"] - 1) * s["b"] * s["n"] * PAIR_OPS
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["issue_ops_per_s"])
