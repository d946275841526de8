"""Device ms a request of the `csrc/` kernels, from the traced section."""


def read(r):
    return r.kernel_ms("hand")
