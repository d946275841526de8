"""Test-time IoU optimisation: gradient ascent of the predicted IoU in the boxes.

Counterpart of ``iou3dmatch_tpu/eval/iou_opt.py:17-58`` (reference
``evaluate_with_opt``, train.py:431-535): gather each proposal's IoU logit
at its argmax semantic class, sum them, and ascend (center, size) along the
gradient of that sum for ``opt_step + 1`` steps at ``opt_rate``, re-running
only the GridConv branch each step; then run it once more on the refined
boxes and re-encode the sizes into ``size_residuals``.

The gradient comes from autograd through ``VoteNet.forward_onlyiou``: the
grid's points and the interpolation weights depend on the boxes, the
``three_nn`` indices and the seeds do not (GridConv detaches the seeds, so
no gradient reaches the gathered table and the gather's backward never
runs). The JAX package runs the steps as one ``lax.scan``.

Here the steps are a Python loop, ``ascend``: on CPU tensors it runs as it
is. On CUDA tensors the host takes two to four times the loop's device time
to issue its few thousand small launches, so the loop is captured once per
input shape as one CUDA graph (``Graphs``) and replayed: the same kernels
in the same order on the same f32 values, so the same bits, in one launch.
"""
import weakref
from collections import OrderedDict

import torch

from ..ops import group_points, three_nn
from ..utils import trace

# The origins GridConv reads, by its ``query_feats`` (``models/grid_conv.py``
# ``GridConv.forward``): a graph's static inputs hold these and no other key.
ORIGINS = {"seed": ("seed_xyz", "seed_features"), "vote": ("vote_xyz", "vote_features"),
           "seed+vote": ("seed_xyz", "vote_features")}
# The hand kernels' wrappers GridConv goes through (its seeds are detached,
# so no gather backward runs): a replay adds to their ``launches`` what its
# capture counted.
COUNTED = (three_nn, group_points)
# Graphs a model keeps: an eval pass meets two shapes, its full batches and
# its last partial one (``cli/common.py::evaluate``).
MAX_GRAPHS = 2


def ascend(model, ep: dict, sem_cls, heading, center, size, opt_rate: float, opt_step: int):
    """The ascent on (center, size) from ``ep``'s origins, then the refined
    boxes' IoU logits: -> (center, size, iou_scores)."""

    def gathered_iou_sum(c, s):
        iou = model.forward_onlyiou(ep, c, s, heading)["iou_scores"]
        if iou.shape[2] > 1:
            iou = torch.gather(iou, 2, sem_cls[..., None])
        return iou.sum()

    with torch.enable_grad():
        for _ in range(opt_step + 1):
            c = center.clone().requires_grad_(True)
            s = size.clone().requires_grad_(True)
            gc, gs = torch.autograd.grad(gathered_iou_sum(c, s), (c, s))
            center, size = center + opt_rate * gc, size + opt_rate * gs
    with torch.no_grad():
        iou = model.forward_onlyiou(ep, center, size, heading)["iou_scores"]
    return center, size, iou


class _Graph:
    """``ascend`` captured for one model and one set of input shapes: its
    static inputs, the graph and its static outputs."""

    def __init__(self, model, keys: tuple, inputs: tuple, opt_rate: float, opt_step: int):
        self.static = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                            for t in inputs)
        self._fill(inputs)

        def run():
            xyz, features, *rest = self.static
            return ascend(model, dict(zip(keys, (xyz, features))), *rest, opt_rate, opt_step)

        # Warm up on the capture's stream first (PyTorch's recipe for
        # capturing autograd): cuBLAS's workspace for that stream, the
        # kernels' libraries and their cudaFuncSetAttribute calls happen
        # here, outside the capture.
        current = torch.cuda.current_stream(inputs[0].device)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            run()
        current.wait_stream(side)
        before = [f.launches for f in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        # "thread_local": the drivers stage the next batch in another thread
        # meanwhile (pinned host buffers, the allocator, copies on the
        # default stream). "global" would make those calls fail, and void
        # the capture; this thread's own unsafe calls (a sync) still fail.
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
            self.outputs = run()
        self.launches = [f.launches - n for f, n in zip(COUNTED, before)]
        for f, n in zip(COUNTED, before):
            f.launches = n  # a capture launches nothing

    def _fill(self, inputs: tuple) -> None:
        for s, t in zip(self.static, inputs):
            s.copy_(t)

    def __call__(self, inputs: tuple) -> tuple:
        """Replays on the current stream; the outputs are copies, which the
        next replay leaves as they are."""
        self._fill(inputs)
        self.graph.replay()
        for f, n in zip(COUNTED, self.launches):
            f.launches += n
        return tuple(t.clone() for t in self.outputs)


class Graphs:
    """Captured ascents, up to ``MAX_GRAPHS`` a model (held weakly), the
    least recently used dropped. A graph reads the model's GridConv weights
    and running statistics by address, so in-place updates reach it, and a
    re-created tensor makes another key. One caller at a time."""

    def __init__(self):
        self.models = weakref.WeakKeyDictionary()

    def run(self, model, keys: tuple, inputs: tuple, opt_rate: float, opt_step: int) -> tuple:
        """``ascend`` on ``inputs`` (origin xyz and features under ``keys``,
        sem_cls, heading, center, size), replayed; captured first where this
        model has no graph for the key."""
        graphs = self.models.setdefault(model, OrderedDict())
        grid_conv = model.grid_conv
        key = (tuple((t.shape, t.dtype, t.device) for t in inputs), keys, opt_rate, opt_step,
               tuple(t.data_ptr() for t in grid_conv.parameters()),
               tuple(t.data_ptr() for t in grid_conv.buffers()),
               torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        graph = graphs.pop(key, None)
        if graph is None:
            graph = _Graph(model, keys, inputs, opt_rate, opt_step)
        graphs[key] = graph
        while len(graphs) > MAX_GRAPHS:
            graphs.popitem(last=False)
        out = graph(inputs)
        trace.tally("iou_opt.graph_replays")
        return out


_GRAPHS = Graphs()


@trace.span("eval.iou_opt", device=True, sync_count=True)
def iou_optimize(model, ep: dict, opt_rate: float, opt_step: int) -> dict:
    """``ep``, outputs of an eval forward that autograd may read (not
    inference tensors; ``train/steps.py::make_eval_loss``'s), -> a new dict
    with refined ``center`` and ``size`` (HALF extents), ``size_residuals``
    re-encoded as size * 2 - mean size of the argmax size class, the same
    for every size cluster, and the refined boxes' ``iou_scores``. The
    model runs in eval mode. CUDA tensors take the captured graph of their
    shapes (the module docstring); the returned tensors are the caller's."""
    model.eval()
    sem_cls = ep["sem_cls_scores"].argmax(-1)
    heading = ep["heading"].detach()
    center, size = ep["center"].detach(), ep["size"].detach()
    if center.is_cuda:
        keys = ORIGINS[model.grid_conv.query_feats]
        inputs = tuple(ep[k].detach() for k in keys) + (sem_cls, heading, center, size)
        center, size, iou = _GRAPHS.run(model, keys, inputs, opt_rate, opt_step)
    else:
        center, size, iou = ascend(model, ep, sem_cls, heading, center, size, opt_rate, opt_step)

    size_class = ep["size_scores"].argmax(-1)
    size_base = model.mean_size[size_class]  # (B, K, 3)
    ns = ep["size_scores"].shape[-1]
    new_ep = dict(ep)
    new_ep["center"] = center
    new_ep["size"] = size
    new_ep["size_residuals"] = (size * 2.0 - size_base)[:, :, None, :].expand(-1, -1, ns, 3)
    new_ep["iou_scores"] = iou
    return new_ep
