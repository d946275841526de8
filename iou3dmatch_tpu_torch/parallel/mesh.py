"""Data groups, batch sharding, replication and the sharded step.

Counterpart of ``iou3dmatch_tpu/parallel/mesh.py``. W ranks, each with a
per-device batch of ``bl`` labeled and ``bu`` unlabeled scenes, compute the
step one process computes on the global batch ``[L_0 ... L_{W-1}; U_0 ...
U_{W-1}]`` (``bl * W`` labeled rows, then ``bu * W`` unlabeled, as JAX's
``cli/train.py:159-160`` sizes it). Rank r holds the rows ``[L_r; U_r]``, a
batch of ``bl`` labeled rows followed by unlabeled ones, as the step reads
it; JAX's ``shard_batch`` cuts the global batch into contiguous rows
instead, a different partition of the same batch.
"""
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from .distributed import DataGroup, make_global_mesh


def make_mesh(n_devices: Optional[int] = None) -> Optional[DataGroup]:
    """The group of every rank, or of the first ``n_devices`` ranks (a new
    process group, which every rank must call for); ranks outside it get
    None."""
    group = make_global_mesh()
    if n_devices is None or n_devices == group.world:
        return group
    if not 1 <= n_devices <= group.world:
        raise ValueError(f"make_mesh: {n_devices} ranks of a {group.world}-rank group")
    pg = dist.new_group(ranks=list(range(n_devices)))
    if group.rank >= n_devices:
        return None
    return DataGroup(rank=group.rank, world=n_devices, device=group.device,
                     backend=group.backend, pg=pg)


def _slices(rank: int, world: int, num_labeled: int, num_unlabeled: int) -> tuple:
    bl, bu = num_labeled // world, num_unlabeled // world
    return (slice(rank * bl, (rank + 1) * bl),
            slice(num_labeled + rank * bu, num_labeled + (rank + 1) * bu))


def take_rows(x, rank: int, world: int, num_labeled: int, num_unlabeled: int = 0):
    """Rank ``rank``'s rows ``[L_r; U_r]`` of ``x`` (a tensor or an array), a
    global batch of ``num_labeled`` labeled rows followed by
    ``num_unlabeled`` unlabeled ones, each count divisible by ``world``: two
    slices joined, so no index array goes to the card."""
    lab, unl = _slices(rank, world, num_labeled, num_unlabeled)
    if torch.is_tensor(x):
        return torch.cat([x[lab], x[unl]]) if num_unlabeled else x[lab]
    return np.concatenate([x[lab], x[unl]]) if num_unlabeled else x[lab]


def shard_batch(batch: dict, group: DataGroup, num_labeled: Optional[int] = None) -> dict:
    """Rank ``group.rank``'s rows ``[L_r; U_r]`` of the global ``batch``,
    whose first ``num_labeled`` rows are labeled (all of them by default,
    as in a pretrain batch): a key with as many rows as the batch gives
    ``[L_r; U_r]``, a label-only key with ``num_labeled`` rows gives
    ``L_r``. Every leading dimension must be divisible by the group size;
    batch sizes are per device in the drivers (global = per_device x
    ranks), so loader batches always are."""
    n = group.world
    bad = {k: tuple(v.shape) for k, v in batch.items()
           if hasattr(v, "shape") and len(v.shape) > 0 and v.shape[0] % n != 0}
    if bad:
        raise ValueError(
            f"shard_batch: leading dims not divisible by the {n}-device mesh: {bad}. Batch "
            f"sizes are per-device (global = per_device * n_devices); the paper config "
            f"--batch_size 4,8 on {n} devices means a global batch of {4 * n}+{8 * n} scenes.")
    total = max(v.shape[0] for v in batch.values() if hasattr(v, "shape") and len(v.shape) > 0)
    nl = total if num_labeled is None else num_labeled
    if nl % n != 0:
        raise ValueError(f"shard_batch: {nl} labeled rows on the {n}-device mesh: labeled and "
                         "unlabeled batch sizes are each per-device")
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape") or len(v.shape) == 0:
            out[k] = v
            continue
        if v.shape[0] not in (total, nl):
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows; the batch has {total} "
                             f"and {nl} labeled")
        out[k] = take_rows(v, group.rank, n, nl, v.shape[0] - nl)
    return out


def _broadcast_tensors(tensors, group: DataGroup) -> None:
    """Rank 0's values of ``tensors`` on every rank, one flat broadcast a
    dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        collectives.broadcast(flat, group, src=dist.get_global_rank(group.pg, 0))
        offset = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def replicate(state, group: DataGroup):
    """Broadcasts the student's and the teacher's parameters and buffers
    from the group's rank 0 into every rank's ``state``, in place, and
    returns it; without a process group, ``state`` as it is. Every rank
    seeds its models and generator alike and reads the same checkpoint, so
    this is the guard that they start equal."""
    if group is None or group.pg is None:
        return state
    models = [m for m in (state.model, state.ema_model) if m is not None]
    _broadcast_tensors([t for m in models for t in (*m.parameters(), *m.buffers())], group)
    return state


def shard_train_step(step_fn, group: DataGroup):
    """Wraps a pretrain or SSL step of ``train/steps.py``:
    ``wrapped(state, batch, lr, bn_momentum, noise=None)`` runs
    ``step_fn`` on this rank's ``batch`` (its rows ``[L_r; U_r]``) with
    ``group`` active, so that the step computes the global batch's step:
    it draws its random tensors at the global shapes and takes its rows,
    its BatchNorm statistics and loss normalisers are global, and it sums
    the gradients over the ranks before Adam. ``noise``, if given, has the
    global batch's shape. Returns the global metrics, all-reduced in one
    flat tensor. Without a process group, ``step_fn`` itself."""
    if group is None or group.pg is None:
        return step_fn

    def wrapped(state, batch, lr, bn_momentum, noise=None):
        with collectives.active(group):
            return collectives.all_reduce_metrics(step_fn(state, batch, lr, bn_momentum,
                                                          noise=noise))

    return wrapped
