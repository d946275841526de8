"""What a per-layer metric's reader reads: the spans of the traced run's
window, the reading of its traced section, and the work of a step or a
request from the configuration's shapes. Each ``metrics/<name>.py`` calls
one of these; a method returns None where there is nothing to read, and
the harness then leaves the metric out."""
from . import shapes


class Reading:
    def __init__(self, config: dict, mix: dict, spans, profile, traced_units: int,
                 window_units: int, window_s: float, peaks: dict, kernel_modules: dict):
        """``window_units`` and ``window_s``: the window's steps or requests
        and seconds outside its profiled section."""
        self.config, self.mix, self.spans, self.profile = config, mix, spans, profile
        self.traced_units, self.window_units, self.window_s = traced_units, window_units, window_s
        self.peaks, self.kernel_modules = peaks, kernel_modules

    def span_ms(self, name: str):
        """The mean of a span over the window, in ms."""
        v = self.spans.mean(name)
        return None if v is None else v * 1e3

    def kernel_ms(self, which: str):
        """``hand`` or ``library`` kernels' device ms a step or request of
        the traced section."""
        if not self.profile or not self.traced_units:
            return None
        return self.profile[f"{which}_s"] / self.traced_units * 1e3

    def roofline_pct(self):
        """Sum of the bounds over the sum of device time of the hand kernels
        with a bound from shapes, each counted only where its launches in
        the traced section are those its calls make (a kernel taken off
        the path, or fused into another, drops out of both sums)."""
        if not self.profile or not self.traced_units:
            return None
        calls = {}
        for kernel, shape in shapes.kernel_calls(self.config, self.mix):
            mod = self.kernel_modules.get(kernel)
            if mod is None or mod.bound_s is None:
                continue
            n, b = calls.get(kernel, (0, 0.0))
            calls[kernel] = (n + 1, b + mod.bound_s(shape, self.peaks))
        bound = spent = 0.0
        for kernel, (n, b) in calls.items():
            per_call = getattr(self.kernel_modules[kernel], "LAUNCHES", 1)
            if self.profile["launches"].get(kernel, 0) != n * per_call * self.traced_units:
                continue
            bound += b * self.traced_units
            spent += self.profile["by_kernel"][kernel]
        return None if spent <= 0 else 100.0 * bound / spent

    def mfu_pct(self):
        """Model FLOPs of the window's steps or requests over the window's
        time, both outside the profiled section, and the peak of the
        configuration's precision."""
        if not self.window_units or self.window_s <= 0:
            return None
        peak = self.peaks["flops"][self.config["precision"]]
        work = shapes.model_flops(self.config, self.mix) * self.window_units
        return 100.0 * work / self.window_s / peak

    def idle_pct(self):
        if not self.profile or self.profile["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.profile["busy_s"] / self.profile["window_s"])
