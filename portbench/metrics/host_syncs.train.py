"""Host-device syncs a step inside the program's span `train.step`
(`train/steps.py`), counted by PyTorch's sync debug mode over the traced
steps (the counter `sync.train.step`, `utils/trace.py`)."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    syncs = None if s is None else s["counters"].get("sync.train.step")
    if syncs is None or not r.traced_units:
        return None
    return syncs / r.traced_units
