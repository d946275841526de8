"""Device ms a step of the `csrc/` kernels (every `kernels/<name>.py` pattern), from the traced section."""


def read(r):
    return r.kernel_ms("hand")
