"""Rotated-IoU training labels for the IoU-prediction branch.

Counterpart of ``iou3dmatch_tpu/losses/iou_labels.py`` (reference
``models/loss_helper_iou.py:22-112``): (B, K, 7) predicted and (B, G, 7)
ground-truth boxes in the (x, y, z, dx, dy, dz, heading) IoU format, with
the heading NEGATED and -1000 placeholder centers for empty GT slots; the
label of a proposal is its largest IoU with a GT of its own scene, computed
only for same-scene pairs (``boxes_iou3d_paired_rows``). No gradient.

``compute_iou_labels_axis_aligned`` is the reference's axis-aligned form
(``loss_helper_iou.py:115-152``, JAX ``iou_labels.py:109-152``): corners
from the argmax size class, ``box3d_iou_axis_aligned`` against every GT of
the scene, differentiable in the predicted center and size residuals.
"""
import torch

from ..geometry.iou3d import box3d_iou_axis_aligned, boxes_iou3d_paired_rows
from ..geometry.nn_distance import nn_distance
from .common import NEAR_THRESHOLD


def placeholder_centers(labels: dict) -> torch.Tensor:
    """GT centers with empty slots moved to (-1000, -1000, -1000)."""
    center = labels["center_label"][..., 0:3]
    return torch.where(labels["box_label_mask"][..., None] > 0, center, -1000.0)


def _gt_boxes(labels: dict, cfg) -> torch.Tensor:
    gt_size = cfg.class2size_tensor(labels["size_class_label"].long(),
                                    labels["size_residual_label"])
    gt_angle = cfg.class2angle_tensor(labels["heading_class_label"],
                                      labels["heading_residual_label"])
    return torch.cat([placeholder_centers(labels), gt_size, -gt_angle[..., None]], -1).float()


def pred_boxes_from_scores(pred_center, pred_heading_scores, pred_heading_residuals,
                           pred_size_scores, pred_size_residuals, cfg) -> torch.Tensor:
    """Argmax-decoded predictions in the (x, y, z, dx, dy, dz, -heading)
    format, detached."""
    with torch.no_grad():
        heading_class = pred_heading_scores.argmax(-1)
        heading_residual = pred_heading_residuals.gather(2, heading_class[..., None])[..., 0]
        size_class = pred_size_scores.argmax(-1)
        size_residual = pred_size_residuals.gather(
            2, size_class[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0, :]
        size = cfg.class2size_tensor(size_class, size_residual)
        size = torch.where(size <= 0, 1e-6, size)
        if cfg.num_heading_bin == 1:
            angle = torch.zeros(size.shape[:2], dtype=torch.float32, device=size.device)
        else:
            angle = cfg.class2angle_tensor(heading_class, heading_residual)
        return torch.cat([pred_center, size, -angle[..., None]], -1).float()


def proposal_gt_iou(labels: dict, pred_center, pred_heading_scores, pred_heading_residuals,
                    pred_size_scores, pred_size_residuals, cfg) -> torch.Tensor:
    """The (B, K, G) rotated IoU of each argmax-decoded proposal with each GT
    box of its scene, one launch of the IoU kernel."""
    pred_bbox = pred_boxes_from_scores(pred_center, pred_heading_scores, pred_heading_residuals,
                                       pred_size_scores, pred_size_residuals, cfg)
    return boxes_iou3d_paired_rows(pred_bbox, _gt_boxes(labels, cfg))


def iou_labels_from(labels: dict, pred_votes, iou: torch.Tensor):
    """(iou_labels (B, K), objectness_label (B, K), object_assignment
    (B, K)) from the (B, K, G) ``proposal_gt_iou``."""
    with torch.no_grad():
        dist1, _, _, _ = nn_distance(pred_votes, placeholder_centers(labels))
        objectness_label = (torch.sqrt(dist1 + 1e-6) < NEAR_THRESHOLD).long()
    iou_labels, object_assignment = iou.max(-1)
    return iou_labels, objectness_label, object_assignment


def compute_iou_labels(labels: dict, pred_votes, pred_center, pred_heading_scores,
                       pred_heading_residuals, pred_size_scores, pred_size_residuals, cfg):
    """``labels``: the GT dict, already cut to the labeled rows. Returns
    (iou_labels (B, K), objectness_label (B, K), object_assignment (B, K)).
    The JAX function's ``reverse`` (the whole IoU, for the pseudo labels'
    coverage) is ``proposal_gt_iou`` here, so that its one matrix serves
    both."""
    iou = proposal_gt_iou(labels, pred_center, pred_heading_scores, pred_heading_residuals,
                          pred_size_scores, pred_size_residuals, cfg)
    return iou_labels_from(labels, pred_votes, iou)


def compute_iou_from_given_size(labels: dict, pred_center, pred_size, pred_heading, cfg):
    """IoU labels of given box parameters (loss_helper_iou.py:22-49).
    Returns (iou_labels (B, K), pred_bbox (B, K, 7), object_assignment (B, K))."""
    gt_bbox = _gt_boxes(labels, cfg)
    pred_size = torch.where(pred_size <= 0, 1e-6, pred_size)
    pred_bbox = torch.cat([pred_center, pred_size, -pred_heading[..., None]], -1).float()
    iou = boxes_iou3d_paired_rows(pred_bbox.detach(), gt_bbox)
    iou_labels, object_assignment = iou.max(-1)
    return iou_labels, pred_bbox, object_assignment


def compute_iou_labels_axis_aligned(labels: dict, pred_votes, pred_center, pred_size_scores,
                                    pred_size_residuals, origin_object_assignment, cfg):
    """Axis-aligned IoU labels. Returns (iou_labels (B, K), iou_zero_mask
    (B, K) int32, final_object_assignment (B, K), {acc_pred_iou,
    acc_pred_iou_obj}). A proposal's label is its largest IoU over the GT
    of its scene (the first GT on ties); where that is below 1e-4 the
    assignment falls back to ``origin_object_assignment``. The gradient
    reaches ``pred_center`` and ``pred_size_residuals`` (at the argmax
    class), not the GT."""
    center_label = placeholder_centers(labels)
    with torch.no_grad():
        dist1, _, _, _ = nn_distance(pred_votes, center_label)
        objectness_label = (torch.sqrt(dist1 + 1e-6) < NEAR_THRESHOLD).to(torch.int32)
    size_class = pred_size_scores.argmax(-1)
    size_residual = pred_size_residuals.gather(
        2, size_class[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0, :]
    gt_size = cfg.class2size_tensor(labels["size_class_label"].long(),
                                    labels["size_residual_label"]) / 2
    gt_corners = torch.stack([gt_size + center_label, center_label - gt_size], 2).detach()
    pred_size = cfg.class2size_tensor(size_class, size_residual) / 2
    pred_corners = torch.stack([pred_size + pred_center, pred_center - pred_size], 2)
    iou = box3d_iou_axis_aligned(gt_corners[:, None], pred_corners[:, :, None])  # (B, K, G)
    iou_labels, object_assignment = iou.max(-1)
    iou_zero_mask = (iou_labels < 1e-4).to(torch.int32)
    final_object_assignment = (origin_object_assignment * iou_zero_mask
                               + object_assignment * (1 - iou_zero_mask))
    obj = objectness_label.to(iou_labels.dtype)
    stats = {"acc_pred_iou": iou_labels.mean(),
             "acc_pred_iou_obj": (iou_labels * obj).sum() / (obj.sum() + 1e-6)}
    return iou_labels, iou_zero_mask, final_object_assignment, stats
