"""Host ms a request of `parse_predictions`, `parse_groundtruths` and `APCalculator.step` at each threshold."""


def read(r):
    return r.span_ms("parse")
