"""Device ms a step of every kernel not built from `csrc/` (cuBLAS, cuDNN, ATen), from the traced section."""


def read(r):
    return r.kernel_ms("library")
