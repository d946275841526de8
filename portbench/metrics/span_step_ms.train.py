"""Host ms a step of the program's span `train.step`, the whole step closure
of `train/steps.py`, the mean over its last 256 calls made with no
profiler recording (`utils/trace.py`)."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    span = None if s is None else s["spans"].get("train.step")
    return None if span is None else span["host_ms"]
