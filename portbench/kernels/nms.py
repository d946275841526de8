"""Greedy NMS of the eval parse (``csrc/nms.cu``, every path). Its rounds
depend on the boxes, so it has no bound from shapes; its time counts among
the hand kernels'."""
PATTERN = r"\bnms_(\w+_)?kernel\b"
bound_s = None
