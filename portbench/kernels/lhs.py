"""Lower-half suppression of the pseudo labels (``csrc/lhs.cu``). Its
rounds depend on the boxes, so it has no bound from shapes; its time counts
among the hand kernels'."""
PATTERN = r"\blhs_(small_)?kernel\b"
bound_s = None
