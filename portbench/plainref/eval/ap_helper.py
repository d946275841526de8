"""Prediction and GT parsing for eval, and AP accumulation.

Counterpart of ``iou3dmatch_tpu/eval/ap_helper.py`` (reference
``models/ap_helper.py:51-435``).

``parse_predictions`` takes the eval forward's tensors on their device. On
the card the box decode runs there (argmax, heading and size from their
bins, corners in float64 cast to float32, as NumPy computes them, and the
camera-frame bounds), the NMS is ``ops/nms.py::nms_boxes`` (``csrc/nms.cu``,
one launch for every scene), and one copy brings the keep mask, corners and
the class and objectness logits to the host, where only the proposals'
probabilities (NumPy's, so AP ranks them as the NumPy parse does) and the
per-class proposal lists are computed. CPU tensors take the same code with the NMS's
plain PyTorch version. ``remove_empty_box`` tests points against each box's
Delaunay hull on the host, as the JAX package does, and feeds the NMS its
``valid`` mask. ``parse_predictions_np`` is the JAX package's NumPy parse,
box by box on the host, kept as the independent reference that the card's
picks are held to.

Picks follow the port's tie order (``geometry/nms.py``). The NMS's scores
are ``softmax`` as ``softmax_np`` computes it (``exp(x - max) / sum``) and
the IoU gate ``1 / (1 + exp(-x))``, in torch on every device; torch's
``exp`` may round otherwise than NumPy's, so the scores may differ from
the NumPy parse's by a few ulps, and a pick only where two boxes that
overlap (and share a class, in the class-aware branch) score within them. The proposals' own scores are NumPy's (``proposal_lists``).
"""
from itertools import repeat

import numpy as np
import torch

from ..geometry.boxes import (flip_axis_to_camera, flip_axis_to_depth, get_3d_box_batch_np,
                              get_3d_box_batch_tensor)
from ..geometry.nms import nms_2d_faster, nms_3d_faster, nms_3d_faster_samecls


def softmax_np(x):
    probs = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return probs / np.sum(probs, axis=-1, keepdims=True)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def predictions2corners3d(ep, config_dict):
    """Decode predictions to camera-frame corners + (B, K, 7) params
    (ap_helper.py:51-93), vectorized."""
    cfg = config_dict["dataset_config"]
    pred_center = _to_np(ep["center"])
    heading_scores = _to_np(ep["heading_scores"])
    heading_residuals = _to_np(ep["heading_residuals"])
    size_scores = _to_np(ep["size_scores"])
    size_residuals = _to_np(ep["size_residuals"])

    pred_heading_class = np.argmax(heading_scores, -1)
    pred_heading_residual = np.take_along_axis(
        heading_residuals, pred_heading_class[..., None], axis=2
    )[..., 0]
    pred_size_class = np.argmax(size_scores, -1)
    pred_size_residual = np.take_along_axis(
        size_residuals, pred_size_class[..., None, None], axis=2
    )[:, :, 0, :]

    heading_angle = cfg.class2angle(pred_heading_class, pred_heading_residual)
    box_size = cfg.mean_size_arr[pred_size_class] + pred_size_residual

    params = np.zeros(pred_center.shape[:2] + (7,), dtype=np.float32)
    params[..., 0:3] = pred_center
    params[..., 3:6] = box_size
    params[..., 6] = heading_angle

    center_cam = flip_axis_to_camera(pred_center)
    corners = get_3d_box_batch_np(box_size, heading_angle, center_cam)
    return corners.astype(np.float32), params


def parse_predictions_np(ep, config_dict):
    """The JAX package's parse in NumPy on the host, box by box and scene by
    scene (JAX ``ap_helper.py:59-157``), with the port's NumPy NMS and its
    tie order: the reference the card's picks are held to, and the host
    cost they replace.
    """
    cfg = config_dict["dataset_config"]
    pred_center = _to_np(ep["center"])
    sem_cls_probs = softmax_np(_to_np(ep["sem_cls_scores"]))
    pred_sem_cls = np.argmax(sem_cls_probs, -1)

    corners, _ = predictions2corners3d(ep, config_dict)
    bsize, k = corners.shape[:2]
    nonempty = np.ones((bsize, k))
    if config_dict.get("remove_empty_box"):
        raise NotImplementedError("remove_empty_box: the benchmark's parse keeps every box")

    obj_prob = softmax_np(_to_np(ep["objectness_scores"]))[:, :, 1]

    mins = corners.min(axis=2)  # (B, K, 3) camera-frame AABB
    maxs = corners.max(axis=2)

    pred_mask = np.zeros((bsize, k))
    if not config_dict["use_3d_nms"]:
        for i in range(bsize):
            boxes2d = np.stack(
                [mins[i, :, 0], mins[i, :, 2], maxs[i, :, 0], maxs[i, :, 2],
                 obj_prob[i]], axis=1,
            )
            keep = np.where(nonempty[i] == 1)[0]
            pick = nms_2d_faster(
                boxes2d[keep], config_dict["nms_iou"], config_dict["use_old_type_nms"]
            )
            assert len(pick) > 0
            pred_mask[i, keep[pick]] = 1
    elif not config_dict["cls_nms"]:
        for i in range(bsize):
            boxes3d = np.concatenate([mins[i], maxs[i], obj_prob[i, :, None]], axis=1)
            keep = np.where(nonempty[i] == 1)[0]
            pick = nms_3d_faster(
                boxes3d[keep], config_dict["nms_iou"], config_dict["use_old_type_nms"]
            )
            assert len(pick) > 0
            pred_mask[i, keep[pick]] = 1
    else:
        scores = obj_prob
        if config_dict.get("use_iou_for_nms"):
            iou_logits = 1.0 / (1.0 + np.exp(-_to_np(ep["iou_scores"])))
            if iou_logits.shape[2] > 1:
                iou_logits = np.take_along_axis(
                    iou_logits, pred_sem_cls[..., None], axis=2
                )
            scores = scores * iou_logits[..., 0]
        for i in range(bsize):
            boxes3d = np.concatenate(
                [mins[i], maxs[i], scores[i, :, None],
                 pred_sem_cls[i, :, None].astype(np.float64)], axis=1,
            )
            keep = np.where(nonempty[i] == 1)[0]
            pick = nms_3d_faster_samecls(
                boxes3d[keep], config_dict["nms_iou"], config_dict["use_old_type_nms"]
            )
            assert len(pick) > 0
            pred_mask[i, keep[pick]] = 1

    batch_pred_map_cls = []
    conf = config_dict["conf_thresh"]
    for i in range(bsize):
        if config_dict["per_class_proposal"]:
            cur = []
            for c in range(cfg.num_class):
                cur += [
                    (c, corners[i, j], sem_cls_probs[i, j, c] * obj_prob[i, j])
                    for j in range(pred_center.shape[1])
                    if pred_mask[i, j] == 1 and obj_prob[i, j] > conf
                ]
            batch_pred_map_cls.append(cur)
        else:
            batch_pred_map_cls.append(
                [
                    (int(pred_sem_cls[i, j]), corners[i, j], obj_prob[i, j])
                    for j in range(pred_center.shape[1])
                    if pred_mask[i, j] == 1 and obj_prob[i, j] > conf
                ]
            )
    return batch_pred_map_cls


