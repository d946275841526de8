"""The grouping gather (``csrc/gather.cu``): q indices read and q rows of c
floats written a scene. The table rows read depend on the indices (at most
the rows written), so they are left out of this lower bound."""
PATTERN = r"\bgather_flat_kernel\b"


def bound_s(s: dict, peak: dict) -> float:
    nbytes = s["b"] * s["q"] * 4 + s["b"] * s["q"] * s["c"] * 4
    return nbytes / peak["hbm_bytes_per_s"]
