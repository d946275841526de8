"""Host ms a request of the program's spans `eval.parse_predictions` and
`eval.parse_groundtruths`, and of `eval.ap_step` once at each of the mix's
AP thresholds (`eval/ap_helper.py`), each the mean over its last 256 calls
made with no profiler recording (`utils/trace.py`)."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    if s is None:
        return None
    ms = [(s["spans"].get(n) or {}).get("host_ms")
          for n in ("eval.parse_predictions", "eval.parse_groundtruths", "eval.ap_step")]
    if None in ms:
        return None
    return ms[0] + ms[1] + len(r.mix["ap_iou_thresholds"]) * ms[2]
