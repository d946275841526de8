"""Host ms a step of the program's span `train.update`: `all_reduce_grads`,
Adam's step and in SSL the EMA (`train/steps.py`), the mean over its last
256 untraced calls."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    span = None if s is None else s["spans"].get("train.update")
    return None if span is None else span["host_ms"]
