"""Device ms a request of the program's span `eval.iou_opt`
(`eval/iou_opt.py::iou_optimize`), between its CUDA events, the mean over
its last 256 calls (`utils/trace.py`)."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    span = None if s is None else s["spans"].get("eval.iou_opt")
    return None if span is None else span["device_ms"]
