"""A host batch to the card in one copy.

The reference moves a batch to the GPU with one ``.to(device)`` a tensor
(pretrain.py:317-318, train.py:329-332), about 15 copies a step.
``stage_batch`` packs every leaf of a host batch into one pinned host
buffer, sends it with one ``non_blocking`` copy and cuts the leaves back
out of the device buffer as typed views. Each leaf keeps its dtype: the
steps read int64 labels, and the JAX package's int64 -> int32 downcast
(``iou3dmatch_tpu/data/staging.py:38-43``) exists only for JAX's default of
no 64-bit types.

The pinned buffer comes from PyTorch's caching host allocator, which
records an event on the stream of each ``non_blocking`` copy out of a block
and hands the block out again only once that event has passed, so a buffer
is never refilled while its copy is in flight; ``chip_smoke.py`` phase 8
stages batches back to back behind a busy stream and checks each one bit
for bit.
"""
import numpy as np
import torch

from ..models.factory import resolve_device
from ..utils import trace

ALIGN = 16  # bytes: every leaf's offset, so that any dtype's view is aligned


def layout(batch: dict):
    """(slots, total bytes) of the packed buffer: a slot (key, dtype, shape,
    offset, bytes) for each leaf in key order, each offset a multiple of
    ``ALIGN``."""
    slots, offset = [], 0
    for k in sorted(batch):
        a = batch[k]
        offset = -(-offset // ALIGN) * ALIGN
        slots.append((k, a.dtype, a.shape, offset, a.nbytes))
        offset += a.nbytes
    return slots, offset


@trace.span("data.stage")
def stage_batch(batch: dict, device=None) -> dict:
    """Host batch (a dict of NumPy arrays) -> dict of tensors on ``device``,
    resolved as ``models/factory.py::resolve_device`` does (CUDA unless the
    caller names a device). On the card: one pinned buffer, one
    ``non_blocking`` copy on the current stream, typed views of one device
    buffer. On the CPU: a copy of each leaf."""
    device = resolve_device(device)
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    if device.type == "cpu":
        return {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}
    slots, total = layout(arrays)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for k, _, _, offset, nbytes in slots:
        buf[offset:offset + nbytes] = np.ascontiguousarray(arrays[k]).reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return {k: dev[offset:offset + nbytes].view(torch.from_numpy(np.empty(0, dtype)).dtype)
            .view(shape) for k, dtype, shape, offset, nbytes in slots}
