"""The gather's backward (``csrc/gather_bwd.cu``, list and sum kernels
together): the cotangent (q rows of c) and the indices read once, the (n,
c) table written once; one add a cotangent element
(``chip_smoke.py::gather_bwd``)."""
PATTERN = r"\bgather_bwd_(list|sum)_kernel\b"
LAUNCHES = 2  # the list kernel, then the sum kernel


def bound_s(s: dict, peak: dict) -> float:
    nbytes = (s["b"] * s["q"] * s["c"] + s["b"] * s["q"] + s["b"] * s["n"] * s["c"]) * 4
    ops = s["b"] * s["q"] * s["c"]
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["issue_ops_per_s"])
