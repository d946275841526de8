"""SSL loss on the unlabeled scenes: the teacher's pseudo labels, then the
student's loss against them.

Counterpart of ``iou3dmatch_tpu/losses/unlabeled.py`` (reference
``models/loss_helper_unlabeled.py``). The pseudo labels (threshold filter,
top-64 pick, lower-half suppression, teacher-to-student frame transforms)
stay on the device in fixed shapes; the reference takes the teacher's
boxes through NumPy for the corners and LHS
(``loss_helper_unlabeled.py:441-492``). Batches are laid out [labeled rows
| unlabeled rows], so the unlabeled scenes are the rows from
``num_labeled`` on.
"""
from typing import Dict

import numpy as np
import torch

from ..geometry.boxes import corners_aabb
from ..geometry.nn_distance import huber_loss, nn_distance, nn_distance_withcls
from ..ops.lhs import lhs_3d_samecls
from ..parallel.collectives import all_reduce_sum
from ..utils import trace
from .common import (FAR_THRESHOLD, NEAR_THRESHOLD, OBJECTNESS_CLS_WEIGHTS, batch_mean,
                     cross_entropy, global_count, global_ratio, masked_mean, one_hot)
from .iou_labels import iou_labels_from, proposal_gt_iou
from .labeled import _take

MAX_NUM_OBJ = 64
TEACHER_KEYS = ("center", "sem_cls_scores", "objectness_scores", "heading_scores",
                "heading_residuals", "size_scores", "size_residuals", "aggregated_vote_xyz",
                "iou_scores")
GT_KEYS = ("center_label", "box_label_mask", "sem_cls_label", "heading_class_label",
           "heading_residual_label", "size_class_label", "size_residual_label")


def _f32(x: float) -> float:
    """A threshold as the f32 the JAX package compares against."""
    return float(np.float32(x))


def _flip(center: torch.Tensor, flip_x: torch.Tensor, flip_y: torch.Tensor) -> torch.Tensor:
    x = torch.where(flip_x[:, None] > 0, -center[..., 0], center[..., 0])
    y = torch.where(flip_y[:, None] > 0, -center[..., 1], center[..., 1])
    return torch.stack([x, y, center[..., 2]], -1)


# --------------------------------------------------------------- transforms
def trans_center(center, flip_x, flip_y, rot_mat, scale):
    """Teacher-frame box centers (B, K, 3) -> student frame
    (loss_helper_unlabeled.py:24-36): flips, then an f32 ``bmm`` with
    ``rot_mat`` transposed, then the scale (B, 1, 3)."""
    return torch.bmm(_flip(center, flip_x, flip_y), rot_mat.transpose(1, 2)) * scale


def trans_size(size_class, size_residual, scale, cfg):
    """Teacher-frame size residuals -> student frame
    (loss_helper_unlabeled.py:39-50)."""
    size_base = cfg.mean_size_tensor(size_residual.device)[size_class.long()]
    return (size_base + size_residual) * scale - size_base


def trans_angle(angle_class, angle_residual, flip_x, flip_y, rot_angle, cfg):
    """Teacher-frame heading -> student frame, binned again (SUN RGB-D only,
    loss_helper_unlabeled.py:54-64). Returns (bin, residual)."""
    angle = cfg.class2angle_tensor(angle_class, angle_residual)
    angle = torch.where(flip_x[:, None] > 0, np.pi - angle, angle)
    angle = torch.where(flip_y[:, None] > 0, -angle, angle)
    return cfg.angle2class_tensor(angle - rot_angle[:, None])


def reverse_trans_center(center, flip_x, flip_y, rot_mat, scale):
    """Student-frame box centers -> teacher frame, the inverse of
    ``trans_center`` (loss_helper_unlabeled.py:67-79): ``rot_mat`` not
    transposed, and 1 / scale."""
    return torch.bmm(_flip(center, flip_x, flip_y), rot_mat) * (1.0 / scale)


def compute_objectness_gt(ep, gt_labels, num_labeled):
    """Objectness of the student's unlabeled rows against their real labels
    (view-stats diagnostics, loss_helper_unlabeled.py:82-135). Returns
    (loss, label, mask, assignment, {"true_unlabeled_obj_acc",
    "unlabeled_obj_acc"}), the reference logging one value under both."""
    nl = num_labeled
    gt_center = torch.where(gt_labels["box_label_mask"][..., None] > 0,
                            gt_labels["center_label"][..., 0:3], -1000.0)
    dist1, ind1, _, _ = nn_distance(ep["aggregated_vote_xyz"][nl:].detach(), gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    label = (euclid < NEAR_THRESHOLD).long()
    mask = ((euclid < NEAR_THRESHOLD) | (euclid > FAR_THRESHOLD)).float()
    scores = ep["objectness_scores"][nl:]
    loss = global_ratio((cross_entropy(scores, label, OBJECTNESS_CLS_WEIGHTS) * mask).sum(),
                        mask.sum())
    acc = global_ratio(((scores.argmax(2) == label).float() * mask).sum(), mask.sum())
    return loss, label, mask, ind1, {"true_unlabeled_obj_acc": acc, "unlabeled_obj_acc": acc}


# ------------------------------------------------------------ pseudo labels
def get_pseudo_labels(teacher: Dict, cfg, obj_threshold, cls_threshold, iou_threshold,
                      nms_iou, use_lhs=True, gt_labels=None):
    """``teacher``: the EMA model's outputs, already cut to the unlabeled
    rows. Returns (pseudo labels, metrics): fixed-shape (B_u, 64[, ...])
    labels in the TEACHER frame, as get_pseudo_labels
    (loss_helper_unlabeled.py:364-538). ``gt_labels``, the real labels of
    those rows, adds the view-stats quality metrics of the pseudo labels
    (loss_helper_unlabeled.py:392-414, :494-523), never a loss."""
    pred_center = teacher["center"]
    k = pred_center.shape[1]
    kmax = min(MAX_NUM_OBJ, k)

    pred_objectness = torch.softmax(teacher["objectness_scores"], 2)
    pos_obj = pred_objectness[..., 1]
    neg_obj_mask = pred_objectness[..., 0] > _f32(0.9)  # a path the reference deprecated, kept
    sem_probs = torch.softmax(teacher["sem_cls_scores"], 2)
    max_cls = sem_probs.amax(2)
    argmax_cls = sem_probs.argmax(2)
    iou_pred = torch.sigmoid(teacher["iou_scores"])
    if iou_pred.shape[2] > 1:
        iou_pred = iou_pred.gather(2, argmax_cls[..., None])[..., 0]
    else:
        iou_pred = iou_pred[..., 0]

    final_mask = ((max_cls > _f32(cls_threshold)) & (pos_obj > _f32(obj_threshold))
                  & (iou_pred > _f32(iou_threshold)))
    trace.count("pseudo.passed", final_mask)  # the boxes that pass the three thresholds
    # the top 64 by pos_obj * max_cls among the boxes that pass; masked keys
    # are all -0.0, so the stable sort alone orders them, as JAX's argsort
    sort_key = pos_obj * max_cls * final_mask.to(pos_obj.dtype)
    inds = torch.argsort(-sort_key, dim=1, stable=True)[:, :kmax]

    def take(x):
        return _take(x, inds)

    final_mask_sorted = take(final_mask)
    metrics = {"pseudo_gt_ratio": batch_mean(final_mask_sorted.float())}
    neg_obj_mask = take(neg_obj_mask)

    if gt_labels is not None:
        # one (B, K, G) IoU gives the teacher's IoU labels and, transposed,
        # the coverage of the GT boxes below
        gt_iou = proposal_gt_iou(gt_labels, pred_center, teacher["heading_scores"],
                                 teacher["heading_residuals"], teacher["size_scores"],
                                 teacher["size_residuals"], cfg)
        iou_labels, vs_obj_label, vs_assignment = iou_labels_from(
            gt_labels, teacher["aggregated_vote_xyz"], gt_iou)
        vs_obj = vs_obj_label.float()
        metrics["unlabeled_pred_iou_value"] = batch_mean(iou_labels)
        metrics["unlabeled_pred_iou_obj_value"] = global_ratio((iou_labels * vs_obj).sum(),
                                                               vs_obj.sum())
        iou_err = (iou_pred - iou_labels).abs()
        metrics["unlabeled_iou_acc"] = batch_mean(iou_err)
        metrics["unlabeled_iou_obj_acc"] = global_ratio((iou_err * vs_obj).sum(), vs_obj.sum())

    argmax_size = teacher["size_scores"].argmax(2)
    argmax_heading = teacher["heading_scores"].argmax(2)
    heading_res = teacher["heading_residuals"].gather(2, argmax_heading[..., None])[..., 0]
    size_res = teacher["size_residuals"].gather(
        2, argmax_size[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0, :]

    center_sel = take(pred_center)
    heading_cls_sel = take(argmax_heading)
    heading_res_sel = take(heading_res)
    size_cls_sel = take(argmax_size)
    size_res_sel = take(size_res)
    sem_cls_sel = take(argmax_cls)
    iou_sel = take(iou_pred)

    if use_lhs:
        # LHS over the axis-aligned bounds of the decoded boxes, scored by
        # pos_obj x predicted IoU, same-class suppression only; the boxes
        # that failed the thresholds take part, as in JAX
        mins, maxs = corners_aabb(center_sel, cfg.class2size_tensor(size_cls_sel, size_res_sel),
                                  cfg.class2angle_tensor(heading_cls_sel, heading_res_sel))
        keep = lhs_3d_samecls(mins.contiguous(), maxs.contiguous(),
                              (take(pos_obj) * iou_sel).contiguous(), sem_cls_sel, nms_iou)
        final_mask_sorted = final_mask_sorted & keep

    if gt_labels is not None:
        # the chosen pseudo labels' quality and the GT boxes they cover
        # (loss_helper_unlabeled.py:494-523)
        fmask = final_mask_sorted.float()
        picked_iou, sel_obj = take(iou_labels), take(vs_obj)
        metrics["final_iou_avg_value"] = global_ratio((picked_iou * fmask).sum(), fmask.sum())
        metrics["final_iou_avg_obj_value"] = global_ratio((picked_iou * fmask * sel_obj).sum(),
                                                          (fmask * sel_obj).sum())
        sel_cls_gt = gt_labels["sem_cls_label"].gather(1, take(vs_assignment))
        correct_cls = (sem_cls_sel == sel_cls_gt).float()
        metrics["final_cls_value"] = global_ratio((correct_cls * fmask).sum(), fmask.sum())
        metrics["final_cls_obj_value"] = global_ratio((correct_cls * fmask * sel_obj).sum(),
                                                      (fmask * sel_obj).sum())
        gt_to_pred = gt_iou.transpose(1, 2)  # (B, G, K)
        gt_to_sel = gt_to_pred.gather(2, inds[:, None, :].expand(-1, gt_to_pred.shape[1], -1))
        best_cover = (gt_to_sel * fmask[:, None, :]).amax(2)  # (B, G)
        gt_count = gt_labels["box_label_mask"].sum()
        metrics["final_coverage_0.25_value"] = global_ratio((best_cover > 0.25).float().sum(),
                                                            gt_count)
        metrics["final_coverage_0.5_value"] = global_ratio((best_cover > 0.5).float().sum(),
                                                           gt_count)

    trace.count("pseudo.kept", final_mask_sorted)  # of those, a scene's top 64 after LHS
    label_mask = final_mask_sorted.int()
    return {
        "unlabeled_box_label_mask": label_mask,
        "unlabeled_center_label": torch.where(label_mask[..., None] > 0, center_sel, -1000.0),
        "unlabeled_sem_cls_label": sem_cls_sel,
        "unlabeled_heading_class_label": heading_cls_sel,
        "unlabeled_heading_residual_label": heading_res_sel,
        "unlabeled_size_class_label": size_cls_sel,
        "unlabeled_size_residual_label": size_res_sel,
        # kept for parity; the loss never reads it
        "unlabeled_false_center_label": torch.where(
            neg_obj_mask[..., None], take(teacher["aggregated_vote_xyz"]), -1000.0),
        "unlabeled_iou_label": iou_sel,
    }, metrics


# ----------------------------------------------------------- student losses
def _pseudo_objectness(ep, pseudo, nl, samecls_match=False):
    """loss_helper_unlabeled.py:137-196. Returns (loss, label, mask,
    assignment)."""
    votes = ep["aggregated_vote_xyz"][nl:].detach()
    gt_center = pseudo["unlabeled_center_label"][..., 0:3]
    if samecls_match:
        dist1, ind1, _, _ = nn_distance_withcls(
            votes, gt_center, ep["sem_cls_scores"][nl:].argmax(2), pseudo["unlabeled_sem_cls_label"])
    else:
        dist1, ind1, _, _ = nn_distance(votes, gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    label = (euclid < NEAR_THRESHOLD).long()
    mask = ((euclid < NEAR_THRESHOLD) | (euclid > FAR_THRESHOLD)).float()
    loss = cross_entropy(ep["objectness_scores"][nl:], label, OBJECTNESS_CLS_WEIGHTS)
    return masked_mean(loss, mask), label, mask, ind1


def _pseudo_box_and_sem_cls_loss(ep, pseudo, nl, cfg, object_assignment, objectness_label):
    """loss_helper_unlabeled.py:199-289. Returns (center, heading cls,
    heading reg, size cls, size reg, sem cls losses)."""
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    obj = objectness_label.float()

    dist1, _, dist2, _ = nn_distance(ep["center"][nl:], pseudo["unlabeled_center_label"][..., 0:3])
    center_loss = masked_mean(dist1, obj) + masked_mean(dist2, pseudo["unlabeled_box_label_mask"])

    def take(key):
        return _take(pseudo[key], object_assignment)

    heading_class_label = take("unlabeled_heading_class_label")
    heading_cls_loss = masked_mean(cross_entropy(ep["heading_scores"][nl:], heading_class_label),
                                   obj)
    hr_norm_label = take("unlabeled_heading_residual_label") / (np.pi / nh)
    hr_pred = (ep["heading_residuals_normalized"][nl:] * one_hot(heading_class_label, nh)).sum(-1)
    heading_reg_loss = masked_mean(huber_loss(hr_pred - hr_norm_label, 1.0), obj)

    size_class_label = take("unlabeled_size_class_label")
    size_cls_loss = masked_mean(cross_entropy(ep["size_scores"][nl:], size_class_label), obj)
    s_onehot = one_hot(size_class_label, ns)[..., None]  # (B, K, NS, 1)
    sr_pred = (ep["size_residuals_normalized"][nl:] * s_onehot).sum(2)
    sr_label = take("unlabeled_size_residual_label") / (
        s_onehot * cfg.mean_size_tensor(obj.device)).sum(2)
    size_reg_loss = masked_mean(huber_loss(sr_pred - sr_label, 1.0).mean(-1), obj)

    sem_cls_loss = masked_mean(
        cross_entropy(ep["sem_cls_scores"][nl:], take("unlabeled_sem_cls_label")), obj)
    return (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
            sem_cls_loss)


def get_unlabeled_loss(ep, ema_ep, batch, cfg, num_labeled, *, obj_threshold=0.9,
                       cls_threshold=0.9, iou_threshold=0.25, nms_iou=0.25, use_lhs=True,
                       samecls_match=False, dataset="scannet", view_stats=False,
                       ema_rows_are_unlabeled=False):
    """Returns (loss, metrics), as get_unlabeled_loss
    (loss_helper_unlabeled.py:541-600): pseudo labels from the teacher's
    unlabeled rows, moved to the student's frame, then the center,
    heading, size and class losses; loss = (box + 0.1 sem_cls) x 10.
    ``ema_rows_are_unlabeled``: the teacher ran on the unlabeled scenes
    alone, so ``ema_ep`` is not cut."""
    nl = num_labeled
    t0 = 0 if ema_rows_are_unlabeled else nl
    teacher = {k: v[t0:] for k, v in ema_ep.items() if k in TEACHER_KEYS}

    gt_labels = None
    if view_stats and all(k in batch and batch[k].shape[0] > nl for k in GT_KEYS):
        # the real labels of the "unlabeled" rows: diagnostics only
        gt_labels = {k: batch[k][nl:] for k in GT_KEYS}

    pseudo, m = get_pseudo_labels(teacher, cfg, obj_threshold, cls_threshold, iou_threshold,
                                  nms_iou, use_lhs, gt_labels=gt_labels)

    # teacher frame -> student frame (loss_helper_unlabeled.py:562-573)
    flip_x, flip_y = batch["flip_x_axis"][nl:], batch["flip_y_axis"][nl:]
    rot_mat, scale = batch["rot_mat"][nl:], batch["scale"][nl:]
    for key in ("unlabeled_center_label", "unlabeled_false_center_label"):
        pseudo[key] = trans_center(pseudo[key], flip_x, flip_y, rot_mat, scale)
    pseudo["unlabeled_size_residual_label"] = trans_size(
        pseudo["unlabeled_size_class_label"], pseudo["unlabeled_size_residual_label"], scale, cfg)
    if dataset == "sunrgbd":
        (pseudo["unlabeled_heading_class_label"],
         pseudo["unlabeled_heading_residual_label"]) = trans_angle(
            pseudo["unlabeled_heading_class_label"], pseudo["unlabeled_heading_residual_label"],
            flip_x, flip_y, batch["rot_angle"][nl:], cfg)

    obj_loss, obj_label, obj_mask, assignment = _pseudo_objectness(ep, pseudo, nl, samecls_match)
    if gt_labels is not None:
        # objectness against the real labels, moved to the student's frame
        # first as the reference does (loss_helper_unlabeled.py:321-323, :575-589)
        gt_student = dict(gt_labels)
        gt_student["center_label"] = trans_center(gt_labels["center_label"][..., 0:3], flip_x,
                                                  flip_y, rot_mat, scale)
        m.update(compute_objectness_gt(ep, gt_student, nl)[4])
        # the reference divides the coverage by the GT count of the whole
        # mixed batch, labeled rows included (loss_helper_unlabeled.py:498)
        ratio = global_ratio(all_reduce_sum(gt_labels["box_label_mask"].sum()) + 1e-6,
                             batch["box_label_mask"].sum())
        for key in ("final_coverage_0.25_value", "final_coverage_0.5_value"):
            m[key] = m[key] * ratio
    m["unlabeled_objectness_loss"] = obj_loss
    total_props = global_count(obj_label.numel())
    m["unlabeled_pos_ratio"] = obj_label.float().sum() / total_props
    m["unlabeled_neg_ratio"] = obj_mask.sum() / total_props - m["unlabeled_pos_ratio"]

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
     sem_cls_loss) = _pseudo_box_and_sem_cls_loss(ep, pseudo, nl, cfg, assignment, obj_label)
    m["unlabeled_center_loss"] = center_loss
    m["unlabeled_heading_cls_loss"] = heading_cls_loss
    m["unlabeled_heading_reg_loss"] = heading_reg_loss
    m["unlabeled_size_cls_loss"] = size_cls_loss
    m["unlabeled_size_reg_loss"] = size_reg_loss
    m["unlabeled_sem_cls_loss"] = sem_cls_loss
    box_loss = (0.1 * heading_cls_loss + heading_reg_loss + 0.1 * size_cls_loss + size_reg_loss
                + center_loss)
    m["unlabeled_box_loss"] = box_loss
    total = (box_loss + 0.1 * sem_cls_loss) * 10.0
    m["unlabeled_detection_loss"] = total
    return total, m
