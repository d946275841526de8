"""Host ms a batch in `data/staging.py::stage_batch` (one pinned buffer, one copy to the card), on the feed's thread a batch ahead of the step, as the drivers' `cli/common.py::staged` runs it."""


def read(r):
    return r.span_ms("stage")
