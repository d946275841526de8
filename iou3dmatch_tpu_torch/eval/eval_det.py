"""VOC-style AP evaluation for 3D detection.

The port's copy of ``iou3dmatch_tpu/eval/eval_det.py``, which mirrors
`utils/eval_det.py:29-261`: per-class greedy IoU matching of
score-sorted detections, PR envelope integration, a process pool over
classes. Host-side by design (matches the reference exactly, including tie
handling and the strict `iou > ovthresh` test).
"""
import numpy as np


def get_iou(bb1, bb2):
    """Axis-aligned 3D IoU on 6-dim (center, lengths) boxes — the
    reference's pluggable default (eval_det.py:66-71)."""
    from ..utils.metrics import calc_iou

    return calc_iou(bb1, bb2)


def get_iou_obb(bb1, bb2):
    """Oriented 3D IoU of two (8, 3) corner boxes by the port's C++ host
    IoU (``native/iou3d_host.cc``), which raises rather than falls back
    when it cannot be built; ``box3d_iou_np.box3d_iou`` is the same
    algorithm in NumPy."""
    from ..native import box3d_iou_native

    return box3d_iou_native(bb1, bb2)[0]


def get_iou_main(get_iou_func, args):
    """Dispatcher kept for surface parity (eval_det.py:80-81)."""
    return get_iou_func(*args)


def voc_ap(rec, prec, use_07_metric=False):
    """PR-envelope AP (eval_det.py:29-61)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False, get_iou_func=get_iou_obb,
                 reference_npos_division=False):
    """Single-class PR (eval_det.py:83-166).

    pred: {img_id: [(bbox, score)]}; gt: {img_id: [bbox]}.

    ``reference_npos_division=True`` reproduces the reference's npos==0
    behavior bit-exactly (0/0 recall -> nan AP, eval_det.py:135) for
    side-by-side comparisons; the default guards it to rec=0 so tiny eval
    subsets do not poison the mAP mean. Identical whenever npos > 0 (every
    class present in GT — always true on the full val sets).
    """
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        bbox = np.array(gt[img_id])
        det = [False] * len(bbox)
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": det}
    for img_id in pred.keys():
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, boxes = [], [], []
    for img_id in pred.keys():
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            boxes.append(box)
    confidence = np.array(confidence)
    boxes = np.array(boxes)

    sorted_ind = np.argsort(-confidence)
    boxes = boxes[sorted_ind, ...]
    image_ids = [image_ids[x] for x in sorted_ind]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = class_recs[image_ids[d]]
        bb = boxes[d, ...].astype(float)
        ovmax = -np.inf
        jmax = -1
        bbgt = rec["bbox"].astype(float)
        if bbgt.size > 0:
            for j in range(bbgt.shape[0]):
                iou = get_iou_func(bb, bbgt[j, ...])
                if iou > ovmax:
                    ovmax = iou
                    jmax = j
        if ovmax > ovthresh:
            if not rec["det"][jmax]:
                tp[d] = 1.0
                rec["det"][jmax] = 1
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    # npos == 0 (class predicted but absent from GT) divides 0/0 in the
    # reference (eval_det.py:135); guard to rec=0 so small eval subsets do
    # not poison the mAP mean. Identical on full val sets where npos > 0.
    if npos > 0 or reference_npos_division:
        with np.errstate(divide="ignore", invalid="ignore"):
            rec = tp / float(npos)
    else:
        rec = np.zeros_like(tp)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap


def _eval_cls_wrapper(args):
    pred, gt, ovthresh, use_07, get_iou_func, ref_npos = args
    return eval_det_cls(pred, gt, ovthresh, use_07, get_iou_func, ref_npos)


def _regroup(pred_all, gt_all):
    pred, gt = {}, {}
    for img_id in pred_all.keys():
        for classname, bbox, score in pred_all[img_id]:
            pred.setdefault(classname, {}).setdefault(img_id, []).append((bbox, score))
            gt.setdefault(classname, {}).setdefault(img_id, [])
    for img_id in gt_all.keys():
        for classname, bbox in gt_all[img_id]:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(bbox)
    return pred, gt


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
             get_iou_func=get_iou_obb, reference_npos_division=False):
    """Multi-class serial evaluation (eval_det.py:173-212)."""
    pred, gt = _regroup(pred_all, gt_all)
    rec, prec, ap = {}, {}, {}
    for classname in gt.keys():
        if classname in pred:
            rec[classname], prec[classname], ap[classname] = eval_det_cls(
                pred[classname], gt[classname], ovthresh, use_07_metric, get_iou_func,
                reference_npos_division
            )
        else:
            rec[classname], prec[classname], ap[classname] = 0, 0, 0
    return rec, prec, ap


def eval_det_multiprocessing(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
                             get_iou_func=get_iou_obb, processes=10,
                             reference_npos_division=False):
    """Pool over classes (eval_det.py:215-261).

    Uses a spawn-context pool: fork() under a live multithreaded runtime
    can deadlock the child. processes<=1 runs serially.
    """
    pred, gt = _regroup(pred_all, gt_all)
    rec, prec, ap = {}, {}, {}
    args = [
        (pred[c], gt[c], ovthresh, use_07_metric, get_iou_func,
         reference_npos_division)
        for c in gt.keys() if c in pred
    ]
    if processes <= 1:
        ret = [_eval_cls_wrapper(a) for a in args]
    else:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(processes=processes) as p:
            ret = p.map(_eval_cls_wrapper, args)
    i = 0
    for classname in gt.keys():
        if classname in pred:
            rec[classname], prec[classname], ap[classname] = ret[i]
            i += 1
        else:
            rec[classname], prec[classname], ap[classname] = 0, 0, 0
    return rec, prec, ap
