"""Training loss on labeled scenes, with the box-jitter IoU loss.

Counterpart of ``iou3dmatch_tpu/losses/labeled.py`` (reference
``models/loss_helper_labeled.py:28-370``). A mixed SSL batch is laid out
[labeled rows | unlabeled rows], so the labeled scenes are the first
``num_labeled`` rows of every end point.
"""
import numpy as np
import torch

from ..geometry.iou3d import boxes_iou3d_paired_rows
from ..geometry.nn_distance import huber_loss, nn_distance
from .common import (FAR_THRESHOLD, GT_VOTE_FACTOR, NEAR_THRESHOLD, OBJECTNESS_CLS_WEIGHTS,
                     cross_entropy, masked_mean, one_hot)
from .iou_labels import _gt_boxes, compute_iou_labels, placeholder_centers

LABEL_KEYS = ("center_label", "box_label_mask", "heading_class_label",
              "heading_residual_label", "size_class_label", "size_residual_label",
              "sem_cls_label", "vote_label", "vote_label_mask")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, G, ...) rows picked by idx (B, K) -> (B, K, ...)."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(idx.shape[:2] + x.shape[2:]))


def compute_vote_loss(ep: dict, batch: dict, nl: int) -> torch.Tensor:
    """loss_helper_labeled.py:28-74: the L1 distance of each seed's vote to
    the nearest of its 3 GT votes, over seeds on an object."""
    seed_xyz = ep["seed_xyz"][:nl]
    seed_inds = ep["seed_inds"][:nl].long()
    bl, num_seed = seed_inds.shape
    mask = batch["vote_label_mask"].gather(1, seed_inds)  # (Bl, S)
    gt_votes = _take(batch["vote_label"], seed_inds) + seed_xyz.tile(1, 1, 3)  # (Bl, S, 9)
    vote_xyz = ep["vote_xyz"][:nl].reshape(bl * num_seed, -1, 3)
    _, _, dist2, _ = nn_distance(vote_xyz, gt_votes.reshape(bl * num_seed, GT_VOTE_FACTOR, 3),
                                 l1=True)
    return masked_mean(dist2.min(1).values.reshape(bl, num_seed), mask)


def compute_objectness_loss(ep: dict, batch: dict, nl: int, placeholders: bool = True):
    """loss_helper_labeled.py:77-123: proposals within 0.3 of a GT center
    are positive, beyond 0.6 negative, between them not counted. With
    ``placeholders`` empty GT slots sit at -1000 (the labeled loss); the
    eval loss takes the raw centers. Returns (loss, label, mask,
    assignment)."""
    gt_center = placeholder_centers(batch) if placeholders else batch["center_label"][..., 0:3]
    dist1, ind1, _, _ = nn_distance(ep["aggregated_vote_xyz"][:nl].detach(), gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    label = (euclid < NEAR_THRESHOLD).long()
    mask = ((euclid < NEAR_THRESHOLD) | (euclid > FAR_THRESHOLD)).float()
    loss = cross_entropy(ep["objectness_scores"][:nl], label, OBJECTNESS_CLS_WEIGHTS)
    return masked_mean(loss, mask), label, mask, ind1


def box_and_sem_cls_losses(ep: dict, batch: dict, nl: int, cfg, object_assignment,
                           objectness_label):
    """Center, heading, size and semantic-class losses of the proposals on
    an object (loss_helper_labeled.py:126-217). Returns (center, heading
    cls, heading reg, size cls, size reg, sem cls losses, sem_cls_label,
    {"cls_acc"})."""
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    obj = objectness_label.float()

    dist1, _, dist2, _ = nn_distance(ep["center"][:nl], batch["center_label"][..., 0:3])
    center_loss = masked_mean(dist1, obj) + masked_mean(dist2, batch["box_label_mask"])

    heading_class_label = _take(batch["heading_class_label"], object_assignment)
    heading_cls_loss = masked_mean(cross_entropy(ep["heading_scores"][:nl], heading_class_label),
                                   obj)
    hr_norm_label = _take(batch["heading_residual_label"], object_assignment) / (np.pi / nh)
    hr_pred = (ep["heading_residuals_normalized"][:nl] * one_hot(heading_class_label, nh)).sum(-1)
    heading_reg_loss = masked_mean(huber_loss(hr_pred - hr_norm_label, 1.0), obj)

    size_class_label = _take(batch["size_class_label"], object_assignment)
    size_cls_loss = masked_mean(cross_entropy(ep["size_scores"][:nl], size_class_label), obj)
    size_residual_label = _take(batch["size_residual_label"], object_assignment)  # (B, K, 3)
    s_onehot = one_hot(size_class_label, ns)[..., None]  # (B, K, NS, 1)
    sr_pred = (ep["size_residuals_normalized"][:nl] * s_onehot).sum(2)
    sr_label = size_residual_label / (s_onehot * cfg.mean_size_tensor(obj.device)).sum(2)
    size_reg_loss = masked_mean(huber_loss(sr_pred - sr_label, 1.0).mean(-1), obj)

    sem_cls_label = _take(batch["sem_cls_label"], object_assignment)
    sem_cls_loss = masked_mean(cross_entropy(ep["sem_cls_scores"][:nl], sem_cls_label), obj)
    m = {"cls_acc": masked_mean((sem_cls_label == ep["sem_cls_scores"][:nl].argmax(-1)).float(),
                                obj)}
    return (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
            sem_cls_loss, sem_cls_label, m)


def _class_iou(scores: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """sigmoid(scores) (B, K, NC) at class ``cls`` (B, K), or the one
    channel of a class-agnostic head."""
    pred = torch.sigmoid(scores)
    if pred.shape[2] > 1:
        return pred.gather(2, cls.long()[..., None])[..., 0]
    return pred[..., 0]


def _jitter_iou_loss(ep: dict, batch: dict, nl: int, cfg, m: dict) -> torch.Tensor:
    """Jittered-box IoU regression (loss_helper_labeled.py:232-279)."""
    heading = ep["jitter_heading"][:nl]
    bl, kj = heading.shape
    pred_bbox = torch.cat([ep["jitter_center"][:nl], ep["jitter_size"][:nl], -heading[..., None]],
                          -1).detach()
    iou = boxes_iou3d_paired_rows(pred_bbox, _gt_boxes(batch, cfg))  # (Bl, Kj, G)
    labels, assignment = iou.max(-1)
    pred = _class_iou(ep["iou_scores_jitter"][:nl], _take(batch["sem_cls_label"], assignment))
    err = (pred - labels).abs()
    m["jitter_iou_acc"] = err.mean()
    m["jitter_iou_acc_obj"] = err.sum() / (bl * kj + 1e-6)
    return huber_loss(pred - labels, 1.0).sum() / (bl * kj + 1e-6)


def get_labeled_loss(ep: dict, batch: dict, cfg, num_labeled: int):
    """Returns (loss, metrics); loss = (vote + 0.5 objectness + box + 0.1
    sem_cls + iou [+ jitter iou]) x 10, as get_labeled_loss
    (loss_helper_labeled.py:300-370)."""
    nl = num_labeled
    batch = {k: (v[:nl] if k in LABEL_KEYS else v) for k, v in batch.items()}
    m = {}
    vote_loss = compute_vote_loss(ep, batch, nl)
    m["vote_loss"] = vote_loss

    objectness_loss, objectness_label, objectness_mask, object_assignment = (
        compute_objectness_loss(ep, batch, nl))
    m["objectness_loss"] = objectness_loss
    total_props = objectness_label.numel()
    m["pos_ratio"] = objectness_label.float().sum() / total_props
    m["neg_ratio"] = objectness_mask.sum() / total_props - m["pos_ratio"]

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
     sem_cls_loss, _, m2) = box_and_sem_cls_losses(ep, batch, nl, cfg, object_assignment,
                                                   objectness_label)
    m.update(m2)
    m["center_loss"] = center_loss
    m["heading_cls_loss"] = heading_cls_loss
    m["heading_reg_loss"] = heading_reg_loss
    m["size_cls_loss"] = size_cls_loss
    m["size_reg_loss"] = size_reg_loss
    m["sem_cls_loss"] = sem_cls_loss
    box_loss = (0.1 * heading_cls_loss + heading_reg_loss + 0.1 * size_cls_loss + size_reg_loss
                + center_loss)
    m["box_loss"] = box_loss

    # IoU-branch loss with rotated-IoU labels (loss_helper_labeled.py:219-295)
    iou_labels, _, iou_assignment = compute_iou_labels(
        batch, ep["aggregated_vote_xyz"][:nl], ep["center"][:nl], ep["heading_scores"][:nl],
        ep["heading_residuals"][:nl], ep["size_scores"][:nl], ep["size_residuals"][:nl], cfg)
    obj_f = objectness_label.float()
    m["pred_iou_value"] = iou_labels.mean()
    m["pred_iou_obj_value"] = masked_mean(iou_labels, obj_f)
    m["obj_count"] = obj_f.sum()
    iou_pred = _class_iou(ep["iou_scores"][:nl], _take(batch["sem_cls_label"], iou_assignment))
    iou_err = (iou_pred - iou_labels).abs()
    m["iou_acc"] = iou_err.mean()
    m["iou_acc_obj"] = masked_mean(iou_err, obj_f)
    iou_loss = huber_loss(iou_pred - iou_labels, 1.0).mean()  # an unmasked mean
    m["iou_loss"] = iou_loss

    total = vote_loss + 0.5 * objectness_loss + box_loss + 0.1 * sem_cls_loss + iou_loss
    if "iou_scores_jitter" in ep:
        jitter_loss = _jitter_iou_loss(ep, batch, nl, cfg, m)
        m["jitter_iou_loss"] = jitter_loss
        total = total + jitter_loss
    total = total * 10.0
    m["detection_loss"] = total
    obj_pred = ep["objectness_scores"][:nl].argmax(2)
    m["obj_acc"] = masked_mean((obj_pred == objectness_label).float(), objectness_mask)
    return total, m
