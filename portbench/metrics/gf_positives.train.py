"""Queries on an object a scene: the program's counter `groupfree.obj_pos`
(`losses/groupfree.py`, the queries whose seed lies on an object, which the
stage losses train on) over the traced steps, divided by their scenes."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    pos = None if s is None else s["counters"].get("groupfree.obj_pos")
    if pos is None or not r.traced_units:
        return None
    return pos / (r.traced_units * r.mix["batch"])
