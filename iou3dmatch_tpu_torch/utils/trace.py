"""Spans and counters inside the program, and their reading.

A span names a block of the program: the train step and its phases, the
staging of a batch, the eval forward, the IoU optimisation, the host
parse. It has two states, decided at each entry by whether a
``torch.profiler`` records on the calling thread (the C flag
``torch._C._autograd._profiler_enabled``, about 0.1 us):

- off (a run without ``--profile_steps``, and outside the traced section
  of a benchmark run): the host clock (``time.perf_counter_ns``, the
  profiler's own clock on Linux) is read at entry and exit, and the
  duration appended to a ring of the name's last ``RING`` calls. No
  profiler range is opened and no CUDA call is made.
- on: the block is also a ``record_function`` range, so that the trace
  shows the program's phases on its own clock; the call takes its place in
  the ring without a host duration, since the profiler slows the host. A
  span made with ``sync_count`` counts the host-device syncs inside it
  into the counter ``sync.<name>``: PyTorch's sync debug mode is set to
  ``warn`` for the block, and its warnings, "called a synchronizing CUDA
  operation", are counted (another thread's in that time count too).

A span made with ``device`` also records a pair of CUDA events around the
block on every call, off or on, in the same ring, where CUDA is in use.

``count(name, tensor)`` adds to a counter while a profiler records, and
does nothing otherwise: the tensor is summed on its device, without a
sync, and the total resolved only by ``snapshot()``. ``tally(name, n)``
adds a host number the same way. So a counter's total is that of the
traced steps. ``snapshot()`` reads every span's mean host ms (and device
ms) over its ring and its number of calls, and every counter's total;
``reset()`` forgets them.

    with trace.span("train.loss"):
        loss = ...

    @trace.span("data.stage")
    def stage_batch(batch, device=None): ...
"""
import threading
import time
import warnings
from collections import deque
from contextlib import ContextDecorator

import torch

RING = 256  # calls kept a span
SYNC_WARNING = "called a synchronizing CUDA operation"

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns


class _Recorder:
    """The rings of the spans and the counters' totals, behind one lock:
    spans are entered on the feed's thread too."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rings = {}  # name -> deque of (host ns or None, (start, end) events or None)
        self.calls = {}
        self.totals = {}  # name -> host number (the syncs, ``tally``)
        self.device_totals = {}  # (name, device) -> tensor on that device

    def record(self, name: str, host_ns, events) -> None:
        with self.lock:
            ring = self.rings.get(name)
            if ring is None:
                ring = self.rings[name] = deque(maxlen=RING)
            ring.append((host_ns, events))
            self.calls[name] = self.calls.get(name, 0) + 1

    def add(self, name: str, value) -> None:
        with self.lock:
            self.totals[name] = self.totals.get(name, 0) + value

    def add_tensor(self, name: str, value: torch.Tensor) -> None:
        total = value.detach().sum()
        key = (name, total.device)
        with self.lock:
            acc = self.device_totals.get(key)
            if acc is None:
                self.device_totals[key] = total
            else:
                acc.add_(total)


_RECORDER = _Recorder()


class span(ContextDecorator):
    """A named span (the module docstring), as a ``with`` block or as a
    function's decorator (a new span each call). ``device``: CUDA events
    around the block too; ``sync_count``: the syncs inside it, while a
    profiler records, into the counter ``sync.<name>``."""

    def __init__(self, name: str, device: bool = False, sync_count: bool = False):
        self.name, self.device, self.sync_count = name, device, sync_count

    def _recreate_cm(self):
        return span(self.name, self.device, self.sync_count)

    def __enter__(self):
        self._range = self._syncs = self._events = None
        if _profiling():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
            if self.sync_count and torch.cuda.is_initialized():
                self._syncs = _SyncWatch()
        if self.device and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = start
        self._t = _clock()
        return self

    def __exit__(self, *exc):
        host_ns = _clock() - self._t
        events = None
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (self._events, end)
        if self._range is not None:
            host_ns = None  # the profiler slowed the host
            if self._syncs is not None:
                _RECORDER.add("sync." + self.name, self._syncs.close())
            self._range.__exit__(None, None, None)
        _RECORDER.record(self.name, host_ns, events)
        return False


class _SyncWatch:
    """PyTorch's sync debug mode at ``warn`` until ``close()``, which
    restores it and returns the syncs it warned of; other warnings are
    issued again under the caller's filters."""

    def __init__(self):
        self.catch = warnings.catch_warnings(record=True)
        self.seen = self.catch.__enter__()
        warnings.simplefilter("always")
        self.mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def close(self) -> int:
        torch.cuda.set_sync_debug_mode(self.mode)
        self.catch.__exit__(None, None, None)
        syncs = 0
        for w in self.seen:
            if SYNC_WARNING in str(w.message):
                syncs += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                       source=w.source)
        return syncs


def count(name: str, value: torch.Tensor) -> None:
    """Adds the sum of ``value``, taken on its device without a sync, to the
    counter ``name`` while a profiler records on this thread; otherwise
    touches nothing."""
    if _profiling():
        _RECORDER.add_tensor(name, value)


def tally(name: str, n: int = 1) -> None:
    """Adds the host number ``n`` to the counter ``name`` while a profiler
    records on this thread; otherwise touches nothing."""
    if _profiling():
        _RECORDER.add(name, n)


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "host_ms", "device_ms"}}, "counters":
    {name: total}}``: each span's calls since ``reset()`` and its mean host
    ms over the calls of its ring made with no profiler recording (None:
    none), and, for a ``device`` span, the mean device ms of its ring's
    event pairs that have completed (None: none); each counter's total,
    its tensors read to the host here."""
    r = _RECORDER
    with r.lock:
        rings = {n: (list(ring), r.calls[n]) for n, ring in r.rings.items()}
        counters = dict(r.totals)
        tensors = list(r.device_totals.items())
    for (name, _), t in tensors:
        counters[name] = counters.get(name, 0) + t.item()
    spans = {}
    for name, (entries, calls) in rings.items():
        host = [h / 1e6 for h, _ in entries if h is not None]
        device = [ev[0].elapsed_time(ev[1]) for _, ev in entries
                  if ev is not None and ev[1].query()]
        spans[name] = {"calls": calls, "host_ms": _mean(host), "device_ms": _mean(device)}
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forgets every span and counter."""
    r = _RECORDER
    with r.lock:
        r.rings.clear()
        r.calls.clear()
        r.totals.clear()
        r.device_totals.clear()
