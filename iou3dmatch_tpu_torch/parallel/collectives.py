"""Collectives with a gradient, and the data group a step runs under.

Under GSPMD the JAX step on n devices is the step on the global batch
(``iou3dmatch_tpu/parallel/__init__.py``): its BatchNorm statistics and its
loss normalisers are sums over every device's rows. The port computes the
same with explicit collectives. ``shard_train_step`` (``mesh.py``) makes its
group the *active* one for the length of a step; inside it each rank's loss
is its share of the global loss (the shares sum to it), and every sum over
the batch axis that a share divides by goes through ``all_reduce_sum``.
Outside a step, and without a process group, every function here is the
identity, so rank 0's eval and every single-process path run as before.

Only ``all_reduce`` and ``broadcast`` are used: they are what ``gloo`` runs
on CUDA tensors, so two ranks can share one card. ``COUNTS`` counts the
collectives issued, the backward's included.
"""
import contextlib
import contextvars

import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "broadcast": 0}
_ACTIVE = contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def active(group):
    """Makes ``group`` (a ``distributed.DataGroup``) the group of the
    collectives below until the block ends; a group without a process
    group activates nothing."""
    token = _ACTIVE.set(group if group is not None and group.pg is not None else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current():
    """The active group, or None."""
    return _ACTIVE.get()


def world() -> int:
    """Ranks of the active group; 1 without one."""
    group = current()
    return 1 if group is None else group.world


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks in place, without a gradient."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group.pg)
    return x


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """In place, from global rank ``src``."""
    COUNTS["broadcast"] += 1
    dist.broadcast(x, src, group=group.pg)
    return x


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of x is the sum over ranks of
    the gradient of y. With each rank's loss its share L_r of L = sum_r L_r,
    dL/dx_r = sum_s dL_s/dy: the backward's all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active group's ranks, differentiable; ``x``
    itself without an active group."""
    group = current()
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active group's ranks, for quantities that
    carry no gradient; ``x`` itself without an active group."""
    group = current()
    if group is None:
        return x
    with torch.no_grad():
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), group)


def global_mean(x: torch.Tensor, n_local) -> torch.Tensor:
    """The mean over every rank's items of a quantity each rank holds as the
    mean ``x`` of its ``n_local`` items: sum_r n_r x_r / sum_r n_r, in one
    all-reduce. No gradient; ``x`` itself without an active group."""
    group = current()
    if group is None:
        return x
    both = torch.cat([x.detach().reshape(-1) * n_local, x.new_full((1,), float(n_local))])
    both = global_sum(both)
    return (both[:-1] / both[-1]).reshape(x.shape)


def all_reduce_grads(params) -> None:
    """Sums the gradients of ``params`` over the active group's ranks in
    place, as one flat buffer, so that every rank's optimizer computes the
    same bits. Parameters without a gradient are left out; every rank has
    the same ones, since every rank runs the same graph."""
    group = current()
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_metrics(metrics: dict) -> dict:
    """Each rank's shares of the metrics -> the global metrics, in one
    all-reduce of one flat tensor; ``metrics`` itself without an active
    group."""
    group = current()
    if group is None or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().reshape(()).to(torch.float64) for k in keys])
    all_reduce_(flat, group)
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}
