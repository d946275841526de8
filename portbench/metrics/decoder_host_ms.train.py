"""Host ms a step of the program's span `model.decoder`
(`models/groupfree.py`: the decoder's projections, layers and heads,
forward only), the mean over its last 256 calls made with no profiler
recording (`utils/trace.py`): the host's time to queue what
`decoder_ms.train` times on the card."""


def _snapshot():
    try:
        from iou3dmatch_tpu_torch.utils.trace import snapshot
    except ImportError:  # a program without spans and counters
        return None
    return snapshot()


def read(r):
    s = _snapshot()
    span = None if s is None else s["spans"].get("model.decoder")
    return None if span is None else span["host_ms"]
