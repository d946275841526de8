"""The measured window, shared by the drivers: ``unit()`` (one step or one
request) called back to back for ``seconds``; with tracing, units
``trace_after`` to ``trace_after + trace_units`` run under the profiler.
The profiled units' host spans, and their time (``traced_s``) in the
window's rate, are left out of the traced run's per-layer numbers: the
profiler slows the host. The trace is read after the window."""
import threading
import time

from .tracing import profiled


class Window:
    def __init__(self, spans, seconds: float, trace: bool, trace_after: int, trace_units: int):
        self.spans, self.seconds, self.trace = spans, seconds, trace
        self.trace_after, self.trace_units = trace_after, trace_units
        self.prof = None
        self.results = []
        self.traced_s = 0.0

    def run(self, unit) -> float:
        """Calls ``unit()`` until the window's time is up (the profiled
        units always run whole); returns the window's seconds. ``unit``'s
        results are kept in ``results``."""
        t0 = time.perf_counter()
        deadline = t0 + self.seconds

        def loop(n=None):
            k = 0
            while (n is None and time.perf_counter() < deadline) or (n is not None and k < n):
                self.results.append(unit())
                k += 1

        if self.trace:
            loop(self.trace_after)
            mark = self.spans.mark()
            self.spans.annotate = True
            t = time.perf_counter()
            with profiled() as prof:
                loop(self.trace_units)
            self.traced_s = time.perf_counter() - t
            self.spans.annotate = False
            self.spans.drop_since(mark)
            self.prof = prof
        loop()
        return time.perf_counter() - t0


class Feed:
    """The port's staging a batch ahead in a thread, as the drivers'
    ``cli/common.py::staged`` runs it (``data/loader.py::prefetch`` over
    ``data/staging.py::stage_batch``), over the host pool in order, round
    and round, until ``close()``."""

    def __init__(self, host: list, stage, spans, device):
        from iou3dmatch_tpu_torch.data.loader import prefetch

        self.stop = threading.Event()

        def batches():
            i = 0
            while not self.stop.is_set():
                yield host[i % len(host)]
                i += 1

        def staged(batch):
            with spans.host("stage"):
                return stage(batch, device=device)

        self.it = prefetch(map(staged, batches()))

    def next(self) -> dict:
        return next(self.it)

    def close(self) -> None:
        self.stop.set()
        for _ in self.it:
            pass
