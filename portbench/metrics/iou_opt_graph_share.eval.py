"""Share of the traced requests whose `eval/iou_opt.py::iou_optimize`
replayed a captured CUDA graph: the counter `iou_opt.graph_replays`
(`utils/trace.py::tally`, one a replay while a profiler records) over the
traced requests. Nothing on a program without `tally`, whose optimisation
replays no graph."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot, tally  # noqa: F401
    except ImportError:  # a program without the counter
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    if s is None or not r.traced_units:
        return None
    return s["counters"].get("iou_opt.graph_replays", 0) / r.traced_units
