"""Device ms a request of `eval/iou_opt.py::iou_optimize`, between CUDA events around the call; nothing where the mix runs no optimisation."""


def read(r):
    return r.span_ms("iou_opt")
