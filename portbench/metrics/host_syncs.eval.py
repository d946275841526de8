"""Host-device syncs a request inside the program's spans `eval.forward`
and `eval.iou_opt` (`train/steps.py::make_eval_loss`,
`eval/iou_opt.py::iou_optimize`), counted by PyTorch's sync debug mode over
the traced requests (the counters `sync.eval.forward` and
`sync.eval.iou_opt`, `utils/trace.py`)."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    forward = None if s is None else s["counters"].get("sync.eval.forward")
    if forward is None or not r.traced_units:
        return None
    return (forward + s["counters"].get("sync.eval.iou_opt", 0)) / r.traced_units
