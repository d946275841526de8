"""Faults planted under the timed path, for the calibration's upper
readings and the tests that see ``correct`` come out false. Each is a
context manager that patches the port's modules while it is open:

- ``unchanged``: the step (or ``iou_optimize``) returns its state unchanged;
- ``half``: half of each batch's rows left out, the mean taken over the
  rest (the first half of each row group copied over the second);
- ``altered``: an answer altered where it is produced (training: one
  leaf's gradient scaled by 1.01 before Adam; eval: the first proposal of
  the first scene dropped from the parse);
- training's Adam gone wrong: ``beta1`` (0.85 for 0.9), ``beta2`` (0.99
  for 0.999), ``fresh_moments`` (its moments cleared before every step, so
  none is carried past the first).

A run on one chip has no exchange between chips to leave out.
"""
from contextlib import contextmanager

import torch

TRAIN = ("unchanged", "half", "altered", "beta1", "beta2", "fresh_moments")
EVAL = ("unchanged", "half", "altered")


@contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _halve(x: torch.Tensor, groups) -> torch.Tensor:
    rows = []
    for lo, n in groups:
        half = max(n // 2, 1)
        rows += [lo + (j % half) for j in range(n)]
    return x[torch.tensor(rows, device=x.device)]


def _row_groups(b: int, nl=None) -> list:
    return [(0, b)] if nl is None else [(0, nl), (nl, b - nl)]


def _set_betas(opt, beta1=None, beta2=None) -> None:
    for g in opt.param_groups:
        b1, b2 = g["betas"]
        g["betas"] = (beta1 or b1, beta2 or b2)


def _before_step(kind: str):
    """What fault ``kind`` does to the train state just before Adam steps."""
    if kind == "altered":
        return lambda state: next(iter(state.model.parameters())).grad.mul_(1.01)
    if kind == "beta1":
        return lambda state: _set_betas(state.optimizer, beta1=0.85)
    if kind == "beta2":
        return lambda state: _set_betas(state.optimizer, beta2=0.99)
    if kind == "fresh_moments":
        return lambda state: state.optimizer.state.clear()
    raise ValueError(f"no training fault {kind!r}")


@contextmanager
def plant(kind: str, mix: dict):
    """Plants fault ``kind`` in the port for the duration of the block."""
    import iou3dmatch_tpu_torch.data.staging as staging
    import iou3dmatch_tpu_torch.eval.ap_helper as ap_helper
    import iou3dmatch_tpu_torch.eval.iou_opt as iou_opt
    import iou3dmatch_tpu_torch.train.steps as steps

    train = mix["driver"] == "train"
    nl = mix.get("labeled") if train and mix.get("step") == "ssl" else None
    if kind == "half":
        real = staging.stage_batch

        def stage_half(batch, device=None):
            out = real(batch, device=device)
            b = out["point_clouds"].shape[0]
            return {k: _halve(v, _row_groups(b, nl)) if v.dim() and v.shape[0] == b else v
                    for k, v in out.items()}

        with patched(staging, "stage_batch", stage_half):
            yield
        return
    if train:
        maker = "make_ssl_step" if mix["step"] == "ssl" else "make_pretrain_step"
        real = getattr(steps, maker)
        before_step = None if kind == "unchanged" else _before_step(kind)

        def make(*a, **k):
            step = real(*a, **k)

            def faulty(state, batch, lr, bn, noise=None):
                if kind == "unchanged":
                    keep = [p.detach().clone() for p in state.model.parameters()]
                    tkeep = [p.detach().clone() for p in state.ema_model.parameters()] \
                        if state.ema_model is not None else []
                    out = step(state, batch, lr, bn, noise)
                    with torch.no_grad():
                        for p, q in zip(state.model.parameters(), keep):
                            p.copy_(q)
                        if tkeep:
                            for p, q in zip(state.ema_model.parameters(), tkeep):
                                p.copy_(q)
                    return out
                opt = state.optimizer
                real_step = opt.step

                def wrong_step(*a2, **k2):
                    before_step(state)
                    return real_step(*a2, **k2)

                opt.step = wrong_step
                try:
                    return step(state, batch, lr, bn, noise)
                finally:
                    opt.step = real_step

            return faulty

        with patched(steps, maker, make):
            yield
        return
    if kind == "unchanged":
        with patched(iou_opt, "iou_optimize", lambda model, ep, rate, n: dict(ep)):
            yield
        return
    real = ap_helper.parse_predictions

    def parse_dropping(ep, config_dict):
        out = real(ep, config_dict)
        if out and out[0]:
            out[0] = out[0][1:]
        return out

    with patched(ap_helper, "parse_predictions", parse_dropping):
        yield
