"""The reading of a traced window, on a made-up trace: a ``record_function``
range that the program opens inside its step shows on the device side of
the trace too, and must move no reading."""
import types

import pytest

from harness import tracing

KERNELS = {"fps": types.SimpleNamespace(PATTERN=r"fps_kernel")}


def _event(name, start_us, end_us, cuda=False, annotation=False, flagged=True):
    kind = ("gpu_user_annotation" if cuda else "user_annotation") if annotation \
        else ("kernel" if cuda else "cpu_op")
    return types.SimpleNamespace(
        name=lambda: name,
        device_type=lambda: "DeviceType.CUDA" if cuda else "DeviceType.CPU",
        start_ns=lambda: start_us * 1000, end_ns=lambda: end_us * 1000,
        is_user_annotation=lambda: annotation and flagged,
        activity_type=lambda: kind if flagged else ("kernel" if cuda else "cpu_op"))


def _profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def _base():
    return [_event(tracing.WINDOW, 0, 1000, annotation=True),
            _event(tracing.WINDOW, 0, 1000, cuda=True, annotation=True),
            _event("dispatch", 10, 600, annotation=True), _event("dispatch", 20, 590, cuda=True, annotation=True),
            _event("void fps_kernel<128>", 50, 150, cuda=True),
            _event("volta_sgemm_128x64_nn", 300, 420, cuda=True),
            _event("Memcpy HtoD (Pinned -> Device)", 700, 720, cuda=True)]


# flagged: the device-side range carries the annotation flag; otherwise
# only its name, that of a host-side range, tells it apart
@pytest.mark.parametrize("flagged", [True, False], ids=["flag", "name only"])
def test_a_range_in_the_program_moves_no_reading(flagged):
    want = tracing.read_profile(_profile(_base()), KERNELS, ["dispatch"])
    ranges = [_event("loss", 100, 500, annotation=True), _event("loss", 160, 480, cuda=True, annotation=True,
                                                flagged=flagged),
              _event("adam", 800, 950, annotation=True), _event("adam", 810, 990, cuda=True, annotation=True,
                                                flagged=flagged)]
    got = tracing.read_profile(_profile(_base() + ranges), KERNELS, ["dispatch"])
    for key in ("busy_s", "hand_s", "library_s", "window_s", "by_kernel", "launches",
                "device_ops"):
        assert got[key] == want[key], key
    assert want["hand_s"] == pytest.approx(100e-6)
    assert want["library_s"] == pytest.approx(120e-6)
    assert want["busy_s"] == pytest.approx(240e-6)
