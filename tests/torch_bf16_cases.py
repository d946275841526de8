"""What the bf16 tests of the port (tests/test_torch_bf16*.py) share.

bf16 keeps 8 significant bits, so one unit in the last place (ulp) of x
is 2^(floor(log2|x|) - 7). Two programs that compute the same f32 value
and round it to bf16 agree unless the f32 values straddle a rounding
boundary, so the packages' bf16 outputs are compared in ulps:
``bf16_ulps`` gives |got - want| in ulps of ``want``, and ``check_bf16``
bounds the share of elements more than one ulp apart and the largest
difference in ulps of the tensor's largest magnitude.
"""
import numpy as np

TINY = np.finfo(np.float32).tiny


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp at each |x| (at f32's smallest normal for 0)."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), TINY)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def bf16_ulps(got, want) -> np.ndarray:
    return np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) / bf16_ulp(want)


def check_bf16(got, want, share: float, what: str = "", scale_ulps: float = 1.0) -> dict:
    """At most ``share`` of the elements more than one bf16 ulp from
    ``want``, and every element within ``scale_ulps`` bf16 ulps of
    max |want|. Returns the measured share and largest difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    over = float((bf16_ulps(got, want) > 1).mean())
    worst = float(np.abs(got - want).max() / bf16_ulp(np.abs(want).max()))
    assert over <= share, f"{what}: {over} of the elements more than 1 bf16 ulp apart"
    assert worst <= scale_ulps, f"{what}: {worst} bf16 ulps of the largest magnitude apart"
    return {"share_over_1_ulp": over, "worst_in_ulps_of_max": worst}


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
