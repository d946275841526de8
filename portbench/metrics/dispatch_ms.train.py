"""Host ms from the call of the step (`train/steps.py`) to its return, before `fetch_metrics` waits for the card: the host's time to queue a step."""


def read(r):
    return r.span_ms("dispatch")
