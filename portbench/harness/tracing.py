"""Spans recorded around the calls into each layer, and the reading of the
traced section of a window (``torch.profiler``).

The harness records its spans from its own files: a host span is the
host clock around a call; a device span is a pair of CUDA events around
it, read once the window has closed. With the profiler on, each host span
is also a ``record_function`` range, so the trace shows what the host was
doing while the card was idle.
"""
import re
import threading
import time
from contextlib import contextmanager

import torch

WINDOW = "portbench.window"


class Spans:
    """Named durations in seconds. ``host(name)`` times a block on the host
    clock; ``device(name)`` records CUDA events around it, resolved by
    ``resolve()`` after the window. While ``annotate`` is on, each host span
    is also a ``record_function`` range, named ``bg:<name>`` off the main
    thread."""

    def __init__(self, annotate: bool = False):
        self.times = {}
        self.pending = []
        self.annotate = annotate

    @contextmanager
    def host(self, name: str):
        ctx = None
        if self.annotate:
            main = threading.current_thread() is threading.main_thread()
            ctx = torch.profiler.record_function(name if main else "bg:" + name)
            ctx.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t)
            if ctx is not None:
                ctx.__exit__(None, None, None)

    @contextmanager
    def device(self, name: str, on: bool = True):
        if not on or not torch.cuda.is_available():
            with self.host(name):
                yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            with self.host(name + ".host"):
                yield
        finally:
            end.record()
            self.pending.append((name, start, end))

    def mark(self) -> tuple:
        return {k: len(v) for k, v in self.times.items()}, len(self.pending)

    def drop_since(self, mark: tuple) -> None:
        """Forgets the spans recorded since ``mark()``."""
        counts, pending = mark
        for k in list(self.times):
            del self.times[k][counts.get(k, 0):]
        del self.pending[pending:]

    def names(self) -> list:
        """Every range name the spans give the trace."""
        return [n for k in self.times for n in (k, "bg:" + k)]

    def resolve(self) -> None:
        if self.pending:
            torch.cuda.synchronize()
        for name, start, end in self.pending:
            self.times.setdefault(name, []).append(start.elapsed_time(end) / 1e3)
        self.pending = []

    def mean(self, name: str):
        v = self.times.get(name)
        return sum(v) / len(v) if v else None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_cuda(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


def _user_annotation(e) -> bool:
    """A ``record_function`` range, host or device side, by the event's own
    flag where this PyTorch has one."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "user_annotation" in str(kind()).lower()


def _interval(e) -> tuple:
    """(start, end) of a kineto event in ns, across PyTorch versions."""
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    if hasattr(e, "end_ns"):
        return start, e.end_ns()
    if hasattr(e, "duration_ns"):
        return start, start + e.duration_ns()
    return start, start + e.duration_us() * 1000


def read_profile(prof, kernel_modules: dict, spans=(), top: int = 10) -> dict:
    """Device time by name, by hand and library kernels, the busy time and
    the idle gaps of the ``WINDOW`` range of a finished profile.

    Device operations are the trace's CUDA events (kernels, and copies and
    fills, named ``Memcpy ...`` and ``Memset ...``) other than the device
    side of the ``record_function`` ranges: the harness's, and any that
    the program opens (a CUDA event flagged as an annotation, or named as
    a host-side annotation of the same trace), so that a range added to
    the program moves no reading. ``kernel_modules`` maps each
    kernel file to its module; a kernel whose name matches a module's
    ``PATTERN`` is a hand kernel of ``csrc/``. An idle gap is named after
    the innermost of the harness's ``spans`` (host ranges) around its
    middle."""
    events = list(prof.profiler.kineto_results.events())
    ranges = set(spans) | {WINDOW}
    window = [_interval(e) for e in events if e.name() == WINDOW and not _is_cuda(e)]
    if not window:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = window[0]
    pats = {k: re.compile(m.PATTERN) for k, m in kernel_modules.items()}
    named_ranges = ranges | {e.name() for e in events if not _is_cuda(e) and _user_annotation(e)}
    device, annotations, by_name, by_kernel, launches = [], [], {}, {}, {}
    hand_s = library_s = 0.0
    for e in events:
        s, t = _interval(e)
        name = e.name()
        if not _is_cuda(e):
            if name in ranges and name != WINDOW:
                annotations.append((s, t, name))
            continue
        if name in named_ranges or _user_annotation(e) or t <= w0 or s >= w1:
            continue
        s, t = max(s, w0), min(t, w1)
        device.append((s, t))
        dur = (t - s) / 1e9
        by_name[name] = by_name.get(name, 0.0) + dur
        if name.startswith(("Memcpy", "Memset")):
            continue
        hit = next((k for k, p in pats.items() if p.search(name)), None)
        if hit is None:
            library_s += dur
        else:
            hand_s += dur
            by_kernel[hit] = by_kernel.get(hit, 0.0) + dur
            launches[hit] = launches.get(hit, 0) + 1
    busy = _union(device)
    busy_s = sum(t - s for s, t in busy) / 1e9
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < w1:
        gaps.append((at, w1))
    named = []
    for s, t in gaps:
        mid = (s + t) / 2
        inner = [a for a in annotations if a[0] <= mid <= a[1]]
        main = [a for a in inner if not a[2].startswith("bg:")]
        inner = main or inner
        name = min(inner, key=lambda a: a[1] - a[0])[2] if inner else "between spans"
        named.append([name, (t - s) / 1e9])
    named.sort(key=lambda x: -x[1])
    ops = sorted(([n[:160], v] for n, v in by_name.items()), key=lambda x: -x[1])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s, "hand_s": hand_s,
            "library_s": library_s, "by_kernel": by_kernel, "launches": launches,
            "device_ops": ops[:top], "idle_gaps": named[:top]}


@contextmanager
def profiled():
    """A ``torch.profiler`` of the CPU and CUDA activity around the block,
    with the block as the ``WINDOW`` range; yields the profiler. The card
    is synchronised at both ends."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW):
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        prof.stop()
