"""The ball query (``csrc/ball_query.cu``): the cloud and the centers read
once, the (m, ns) indices written once. Its distance tests depend on where
the points lie, so only the bytes bound it here (``chip_smoke.py``'s bytes)."""
PATTERN = r"\bball_query_kernel\b"


def bound_s(s: dict, peak: dict) -> float:
    nbytes = s["b"] * s["n"] * 12 + s["b"] * s["m"] * 12 + s["b"] * s["m"] * s["ns"] * 4
    return nbytes / peak["hbm_bytes_per_s"]
