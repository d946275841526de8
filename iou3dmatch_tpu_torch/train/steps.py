"""Eval forward.

Counterpart of ``iou3dmatch_tpu/train/steps.py::make_eval_forward``
(``:222-245``) without the eval loss metrics, which come with the losses.
"""
import torch

KEEP = (
    "center", "heading_scores", "heading_residuals", "size_scores",
    "size_residuals", "sem_cls_scores", "objectness_scores",
    "iou_scores", "size", "heading", "seed_xyz", "seed_features",
    "vote_xyz", "vote_features", "aggregated_vote_xyz",
)


def make_eval_forward(model):
    """Returns ``forward(point_clouds) -> dict`` of the outputs the host-side
    AP pipeline reads. It runs ``model`` in eval mode under
    ``torch.inference_mode()``; the outputs stay on the model's device."""

    def forward(point_clouds: torch.Tensor) -> dict:
        model.eval()
        with torch.inference_mode():
            ep = model(point_clouds)
        return {k: ep[k] for k in KEEP if k in ep}

    return forward
