"""Process-group bring-up and the data group.

Counterpart of ``iou3dmatch_tpu/parallel/distributed.py``. JAX starts its
distributed runtime once a host and builds one global mesh; in PyTorch every
rank is a process of its own (one a card, started by ``torchrun``), joined by
a ``torch.distributed`` process group, and ``DataGroup`` is the mesh's
counterpart: the rank, the world, the rank's device and the backend.
"""
import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 1800  # torch's own default: a barrier waits out rank 0's eval


@dataclass(frozen=True)
class DataGroup:
    """A 1-D data-parallel group: this process's ``rank`` of ``world``, its
    ``device`` and the ``backend``; ``pg`` is the process group, None for a
    single process without one (rank 0 of 1), whose collectives are the
    identity."""
    rank: int = 0
    world: int = 1
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    pg: Optional[object] = None


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(f"initialize_distributed: {name} is not set; start the ranks with "
                           "torchrun, or pass init_method, world_size and rank")
    return int(os.environ[name])


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, device_type: str = "cuda",
                           timeout_s: float = TIMEOUT_S, logger=print) -> DataGroup:
    """Joins the process group and returns this rank's ``DataGroup``.

    By default it reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``:
    ``init_method`` "env://"); explicit arguments take the place of JAX's
    ``coordinator_address``, ``num_processes`` and ``process_id``. Across
    hosts, torchrun's ``--nnodes`` sets the same variables.

    The device: with ``device_type`` "cuda", rank r uses
    ``cuda:(LOCAL_RANK % device_count)``. The backend: ``nccl`` where each
    local rank has a card of its own, ``gloo`` where local ranks share a card
    (NCCL refuses two ranks on one device) and on the CPU. It logs the rule
    it took in one line. ``timeout_s`` bounds the rendezvous and every
    collective, so that a rank that never arrives fails by name."""
    world = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    local_rank, local_world = _local(rank, world)
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("initialize_distributed: CUDA asked for and no card is visible; "
                               "pass --device cpu to run the ranks on the CPU")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= cards else "gloo"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device_type is 'cuda' or 'cpu', not {device_type!r}")
    try:
        dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # noqa: BLE001 - re-raised with the rank that waited
        raise RuntimeError(f"rank {rank} of {world} could not join the process group "
                           f"({backend}, {init_method or 'env://'}) within {timeout_s} s: "
                           f"{e}") from e
    group = DataGroup(rank=rank, world=world, device=device, backend=backend,
                      pg=dist.group.WORLD)
    logger(describe(group))
    return group


def _local(rank: int, world: int) -> tuple:
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def describe(group: DataGroup) -> str:
    """The group's line: ranks, device, backend and the rule that chose it."""
    local_rank, local_world = _local(group.rank, group.world)
    if group.device is not None and group.device.type == "cuda":
        cards = torch.cuda.device_count()
        rule = (f"{cards} card(s) for {local_world} local rank(s): "
                + ("a card each" if group.backend == "nccl" else "ranks share a card"))
    else:
        rule = "CPU"
    return (f"distributed: rank {group.rank} of {group.world}, local rank {local_rank} of "
            f"{local_world}, device {group.device}, backend {group.backend} ({rule})")


def barrier(group: Optional[DataGroup]) -> None:
    """Waits for every rank of ``group``; nothing without a process group."""
    if group is None or group.pg is None:
        return
    if group.backend == "nccl":
        dist.barrier(group=group.pg, device_ids=[group.device.index])
    else:
        dist.barrier(group=group.pg)


def make_global_mesh() -> DataGroup:
    """The group of every rank (the default process group), or a single
    process's ``DataGroup()`` without one. The device is the current card's
    where CUDA is initialised, else the CPU."""
    if not dist.is_initialized():
        return DataGroup()
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" or (torch.cuda.is_available() and torch.cuda.is_initialized())
              else torch.device("cpu"))
    return DataGroup(rank=dist.get_rank(), world=dist.get_world_size(), device=device,
                     backend=backend, pg=dist.group.WORLD)


def host_local_batch_to_global(batch, group: DataGroup):
    """JAX assembles one global array from each host's rows. In PyTorch a
    rank's process already holds its own rows, and the step computes on the
    global batch through collectives (``collectives.py``), so a rank's
    host-local batch is its share as it stands: this returns ``batch``.
    ``mesh.shard_batch`` gives a rank its rows of a batch that every rank
    holds whole."""
    del group
    return batch


def shutdown() -> None:
    """Leaves the process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
