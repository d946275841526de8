"""Device ms a request of `make_eval_loss` (the forward and the eval loss), between CUDA events around the call."""


def read(r):
    return r.span_ms("forward")
