"""Host ms a step of the program's span `train.teacher`, the SSL teacher's
forward under `no_grad` (`train/steps.py::make_ssl_step`), the mean over
its last 256 untraced calls; None in a step without a teacher."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    span = None if s is None else s["spans"].get("train.teacher")
    return None if span is None else span["host_ms"]
