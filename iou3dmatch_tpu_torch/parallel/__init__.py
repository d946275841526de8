"""Data parallelism over ranks, the counterpart of ``iou3dmatch_tpu/parallel``.

JAX shards the batch over a 1-D ``data`` mesh and GSPMD inserts the gradient
all-reduce and the cross-replica BatchNorm statistics. In PyTorch each rank
is a process (``torchrun``) joined by a ``torch.distributed`` group, and
the same step is written out: ``collectives.py`` holds the all-reduces with
a gradient, ``models/mlp.py::BatchNorm`` and ``losses/`` sum over the ranks
through them while a step runs under ``shard_train_step``, and the steps
all-reduce the gradient before Adam. Rank r holds the rows ``[L_r; U_r]`` of
the global batch (``mesh.py``).
"""
from .distributed import (DataGroup, host_local_batch_to_global, initialize_distributed,
                          make_global_mesh)
from .mesh import make_mesh, replicate, shard_batch, shard_train_step, take_rows

__all__ = [
    "make_mesh", "shard_batch", "replicate", "shard_train_step", "take_rows",
    "initialize_distributed", "make_global_mesh", "host_local_batch_to_global", "DataGroup",
]
