"""Pseudo labels kept an unlabeled scene: the program's counter
`pseudo.kept` (`losses/unlabeled.py::get_pseudo_labels`, the teacher's
boxes that pass objectness, class and IoU, of the top 64 those LHS keeps)
over the traced steps, divided by their unlabeled scenes."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    kept = None if s is None else s["counters"].get("pseudo.kept")
    if kept is None or not r.traced_units:
        return None
    return kept / (r.traced_units * r.mix["unlabeled"])
