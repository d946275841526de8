"""Evaluation-path loss and metrics.

Counterpart of ``iou3dmatch_tpu/losses/supervised.py`` (reference
``models/loss_helper.py:25-291``): the labeled loss without placeholder
centers in the objectness assignment, without the jitter term, with the
IoU loss masked by objectness and the IoU prediction read at the
predicted class.
"""
from ..geometry.nn_distance import huber_loss
from .common import masked_mean
from .iou_labels import compute_iou_labels
from .labeled import (_class_iou, box_and_sem_cls_losses, compute_objectness_loss,
                      compute_vote_loss)


def get_loss(ep: dict, batch: dict, cfg):
    """Returns (loss, metrics); loss = (vote + 0.5 objectness + box + 0.1
    sem_cls [+ iou]) x 10 over every scene of ``batch``."""
    nl = batch["center_label"].shape[0]
    m = {}
    vote_loss = compute_vote_loss(ep, batch, nl)
    m["vote_loss"] = vote_loss
    objectness_loss, objectness_label, objectness_mask, object_assignment = (
        compute_objectness_loss(ep, batch, nl, placeholders=False))
    m["objectness_loss"] = objectness_loss
    total_props = objectness_label.numel()
    m["pos_ratio"] = objectness_label.float().sum() / total_props
    m["neg_ratio"] = objectness_mask.sum() / total_props - m["pos_ratio"]

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
     sem_cls_loss, sem_cls_label, m2) = box_and_sem_cls_losses(
        ep, batch, nl, cfg, object_assignment, objectness_label)
    # the eval path's cls_acc is over all proposals (loss_helper.py:188-189)
    m["cls_acc"] = (sem_cls_label == ep["sem_cls_scores"][:nl].argmax(-1)).float().mean()
    m["cls_acc_obj"] = m2["cls_acc"]
    m["center_loss"] = center_loss
    m["heading_cls_loss"] = heading_cls_loss
    m["heading_reg_loss"] = heading_reg_loss
    m["size_cls_loss"] = size_cls_loss
    m["size_reg_loss"] = size_reg_loss
    m["sem_cls_loss"] = sem_cls_loss
    box_loss = (0.1 * heading_cls_loss + heading_reg_loss + 0.1 * size_cls_loss + size_reg_loss
                + center_loss)
    m["box_loss"] = box_loss

    iou_labels, _, _ = compute_iou_labels(
        batch, ep["aggregated_vote_xyz"][:nl], ep["center"][:nl], ep["heading_scores"][:nl],
        ep["heading_residuals"][:nl], ep["size_scores"][:nl], ep["size_residuals"][:nl], cfg)
    obj_f = objectness_label.float()
    m["pred_iou_value"] = iou_labels.mean()
    m["pred_iou_obj_value"] = masked_mean(iou_labels, obj_f)

    total = vote_loss + 0.5 * objectness_loss + box_loss + 0.1 * sem_cls_loss
    if "iou_scores" in ep:
        # read at the PREDICTED class (loss_helper.py:208-212)
        iou_pred = _class_iou(ep["iou_scores"][:nl], ep["sem_cls_scores"][:nl].argmax(-1))
        iou_err = (iou_pred - iou_labels).abs()
        m["iou_acc"] = iou_err.mean()
        m["iou_acc_obj"] = masked_mean(iou_err, obj_f)
        iou_loss = masked_mean(huber_loss(iou_pred - iou_labels, 1.0), obj_f)
        m["iou_loss"] = iou_loss
        total = total + iou_loss
    total = total * 10.0
    m["detection_loss"] = total
    obj_pred = ep["objectness_scores"][:nl].argmax(2)
    m["obj_acc"] = masked_mean((obj_pred == objectness_label).float(), objectness_mask)
    return total, m
