"""Axis-aligned box IoU and scene precision/recall (host NumPy).

The port's copy of ``iou3dmatch_tpu/utils/metrics.py`` (reference
``utils/metric_util.py``): ``calc_iou`` on 6-dim (center, lengths) boxes,
which ``eval/eval_det.py::get_iou`` reads, a scene's TP/FP/FN and their
sum over scenes.
"""
import numpy as np


def calc_iou(box_a, box_b):
    """Axis-aligned 3D IoU of two 6-dim boxes [cx, cy, cz, lx, ly, lz]
    (metric_util.py:107-131)."""
    box_a, box_b = np.asarray(box_a), np.asarray(box_b)
    max_a = box_a[0:3] + box_a[3:6] / 2
    max_b = box_b[0:3] + box_b[3:6] / 2
    min_max = np.array([max_a, max_b]).min(0)
    min_a = box_a[0:3] - box_a[3:6] / 2
    min_b = box_b[0:3] - box_b[3:6] / 2
    max_min = np.array([min_a, min_b]).max(0)
    if not (min_max > max_min).all():
        return 0.0
    intersection = (min_max - max_min).prod()
    vol_a = box_a[3:6].prod()
    vol_b = box_b[3:6].prod()
    union = vol_a + vol_b - intersection
    return 1.0 * intersection / union


def single_scene_precision_recall(labels, pred, iou_thresh, conf_thresh):
    """One scene's TP, FP, FN, class-agnostic (metric_util.py:61-96).

    labels: (N, >=6) GT boxes [center, lengths]; pred: (M, >=7) predicted
    boxes with the confidence in column 6. A GT box counts as matched if any
    confident prediction overlaps it by ``iou_thresh`` or more: no
    one-to-one assignment, as in the reference."""
    labels, pred = np.asarray(labels), np.asarray(pred)
    gt_bboxes = labels[:, :6]
    num_scene_bboxes = gt_bboxes.shape[0]
    conf = pred[:, 6]
    conf_pred_bbox = pred[np.where(conf > conf_thresh)[0], :6]
    num_conf_pred_bboxes = conf_pred_bbox.shape[0]

    iou_arr = np.zeros([num_conf_pred_bboxes, num_scene_bboxes])
    for g_idx in range(num_conf_pred_bboxes):
        for s_idx in range(num_scene_bboxes):
            iou_arr[g_idx, s_idx] = calc_iou(conf_pred_bbox[g_idx, :], gt_bboxes[s_idx, :])

    good_match_arr = iou_arr >= iou_thresh
    tp = good_match_arr.any(axis=1).sum()
    fp = num_conf_pred_bboxes - tp
    fn = num_scene_bboxes - good_match_arr.any(axis=0).sum()
    return tp, fp, fn


def multi_scene_precision_recall(labels, pred, iou_thresh, conf_thresh,
                                 label_mask, pred_mask=None):
    """Sum of ``single_scene_precision_recall`` over a batch
    (metric_util.py:28-58). labels: (B, N, 6); pred: (B, M, 7); masks:
    (B, N) and (B, M) in {0, 1}. Returns TP, FP, FN, (precision, recall)."""
    labels, pred = np.asarray(labels), np.asarray(pred)
    if label_mask is None:
        label_mask = np.ones((labels.shape[0], labels.shape[1]))
    if pred_mask is None:
        pred_mask = np.ones((pred.shape[0], pred.shape[1]))
    TP, FP, FN = 0, 0, 0
    for batch_idx in range(labels.shape[0]):
        TP_i, FP_i, FN_i = single_scene_precision_recall(
            labels[batch_idx, label_mask[batch_idx, :] == 1, :],
            pred[batch_idx, pred_mask[batch_idx, :] == 1, :],
            iou_thresh, conf_thresh)
        TP += TP_i
        FP += FP_i
        FN += FN_i
    return TP, FP, FN, precision_recall(TP, FP, FN)


def precision_recall(TP, FP, FN):
    """(TP, FP, FN) -> (precision, recall) (metric_util.py:99-103)."""
    prec = 1.0 * TP / (TP + FP) if TP + FP > 0 else 0
    rec = 1.0 * TP / (TP + FN)
    return prec, rec
