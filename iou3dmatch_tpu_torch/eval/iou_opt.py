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
runs). The JAX package runs the steps as one ``lax.scan``; here each is a
Python step of a forward and a backward on the card.
"""
import torch

from ..utils import trace


@trace.span("eval.iou_opt", device=True, sync_count=True)
def iou_optimize(model, ep: dict, opt_rate: float, opt_step: int) -> dict:
    """``ep``, outputs of an eval forward that autograd may read (not
    inference tensors; ``train/steps.py::make_eval_loss``'s), -> a new dict
    with refined ``center`` and ``size`` (HALF extents), ``size_residuals``
    re-encoded as size * 2 - mean size of the argmax size class, the same
    for every size cluster, and the refined boxes' ``iou_scores``. The
    model runs in eval mode."""
    model.eval()
    sem_cls = ep["sem_cls_scores"].argmax(-1)
    heading = ep["heading"].detach()
    center, size = ep["center"].detach(), ep["size"].detach()

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
        out = model.forward_onlyiou(ep, center, size, heading)

    size_class = ep["size_scores"].argmax(-1)
    size_base = model.mean_size[size_class]  # (B, K, 3)
    ns = ep["size_scores"].shape[-1]
    new_ep = dict(ep)
    new_ep["center"] = center
    new_ep["size"] = size
    new_ep["size_residuals"] = (size * 2.0 - size_base)[:, :, None, :].expand(-1, -1, ns, 3)
    new_ep["iou_scores"] = out["iou_scores"]
    return new_ep
