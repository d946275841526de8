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
from ..ops.nms import nms_boxes
from ..utils import trace
from .eval_det import eval_det_multiprocessing, get_iou_obb


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


def _heading_f64(cfg, cls: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """``cfg.class2angle`` in float64 on tensors, as NumPy computes it: 0
    with one bin (ScanNet), else cls * 2 pi / bins + residual, less 2 pi
    above pi."""
    if cfg.num_heading_bin == 1:
        return torch.zeros(cls.shape, dtype=torch.float64, device=cls.device)
    angle = cls.double() * (2 * np.pi / float(cfg.num_heading_bin)) + residual.double()
    return angle - 2 * np.pi * (angle > np.pi).double()


def decode_corners(ep, cfg) -> torch.Tensor:
    """``predictions2corners3d``'s corners on the outputs' device: (B, K, 8,
    3) float32 upright-camera corners, computed in float64 from the argmax
    heading and size bins and their residuals."""
    heading_scores = _tensor(ep["heading_scores"])
    size_scores = _tensor(ep["size_scores"])
    heading_class = heading_scores.argmax(-1)
    heading_residual = torch.gather(_tensor(ep["heading_residuals"]), 2,
                                    heading_class[..., None])[..., 0]
    size_class = size_scores.argmax(-1)
    size_residual = torch.gather(_tensor(ep["size_residuals"]), 2,
                                 size_class[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0, :]
    mean = torch.as_tensor(cfg.mean_size_arr, dtype=torch.float64, device=size_scores.device)
    box_size = mean[size_class] + size_residual.double()
    heading = _heading_f64(cfg, heading_class, heading_residual)
    center = _tensor(ep["center"])
    center_cam = torch.stack([center[..., 0], -center[..., 2], center[..., 1]], -1).double()
    return get_3d_box_batch_tensor(box_size, heading, center_cam).float()


def nonempty_boxes(corners: np.ndarray, point_clouds: np.ndarray) -> np.ndarray:
    """(B, K) bool: the boxes of (B, K, 8, 3) camera-frame corners that hold
    at least 5 of their scene's points (JAX ``ap_helper.py:70-89``,
    reference ``ap_helper.py:119-135``), by Delaunay hull on the host."""
    from ..data.sunrgbd_calib import extract_pc_in_box3d

    b, k = corners.shape[:2]
    keep = np.ones((b, k), dtype=bool)
    for i in range(b):
        pc = point_clouds[i, :, 0:3]
        for j in range(k):
            pc_in_box, _ = extract_pc_in_box3d(pc, flip_axis_to_depth(corners[i, j]))
            keep[i, j] = len(pc_in_box) >= 5
    return keep


def _need_clouds(ep):
    if "point_clouds" not in ep:
        raise KeyError(
            "parse_predictions(remove_empty_box=True) needs the scene "
            "clouds: pass ep['point_clouds'] (B, N, C) alongside the "
            "model outputs (the eval forward does not return inputs; see "
            "cli/common.py evaluate())")
    return _to_np(ep["point_clouds"])


def nms_mode(config_dict) -> str:
    """The NMS branch ``config_dict`` selects: ``2d``, ``3d`` or ``3d_cls``."""
    if not config_dict["use_3d_nms"]:
        return "2d"
    return "3d_cls" if config_dict["cls_nms"] else "3d"


def nms_scores(ep, config_dict):
    """The NMS's (B, K) float32 scores and the (B, K) class its class-aware
    branch gates on, on the outputs' device (JAX ``ap_helper.py:66-115``):
    the objectness probability, times ``1 / (1 + exp(-x))`` of the IoU logit
    at that class with ``use_iou_for_nms`` in the class-aware branch. The
    class is the argmax of the logits; the JAX parse takes it of their
    softmax, which differs only where two probabilities round equal."""
    sem_cls = _tensor(ep["sem_cls_scores"]).argmax(-1)
    obj = _tensor(ep["objectness_scores"])
    probs = torch.exp(obj - obj.amax(-1, keepdim=True))
    scores = probs[..., 1] / probs.sum(-1)
    if nms_mode(config_dict) == "3d_cls" and config_dict.get("use_iou_for_nms"):
        gate = 1.0 / (1.0 + torch.exp(-_tensor(ep["iou_scores"])))
        if gate.shape[2] > 1:
            gate = torch.gather(gate, 2, sem_cls[..., None])
        scores = scores * gate[..., 0]
    return scores, sem_cls


def pack_predictions(ep, config_dict) -> np.ndarray:
    """The device half of ``parse_predictions``: the decode, the NMS on the
    outputs' device and one copy to the host of (B, K, 24 + C + 4) float32,
    the layout ``proposal_lists`` reads. ``remove_empty_box`` tests the
    decoded boxes on the host and feeds the NMS its ``valid`` mask."""
    cfg = config_dict["dataset_config"]
    corners = decode_corners(ep, cfg)
    b, k = corners.shape[:2]
    valid = None
    if config_dict.get("remove_empty_box"):
        clouds = _need_clouds(ep)
        valid = torch.from_numpy(nonempty_boxes(corners.cpu().numpy(), clouds)).to(corners.device)
    mode = nms_mode(config_dict)
    scores, sem_cls = nms_scores(ep, config_dict)
    keep = nms_boxes(corners.amin(2), corners.amax(2), scores.contiguous(),
                     sem_cls if mode == "3d_cls" else None, valid, mode,
                     config_dict["use_old_type_nms"], config_dict["nms_iou"])
    packed = torch.cat([corners.reshape(b, k, 24), _tensor(ep["sem_cls_scores"]),
                        _tensor(ep["objectness_scores"]), keep[..., None].float(),
                        sem_cls[..., None].float()], -1)
    return packed.cpu().numpy()


@trace.span("eval.parse_predictions")
def parse_predictions(ep, config_dict):
    """NMS + per-class proposal lists (JAX ``ap_helper.py:59-157``,
    reference ``ap_helper.py:96-221``): ``pack_predictions`` on the
    outputs' device, then ``proposal_lists`` on the host (the module
    docstring).

    Returns batch_pred_map_cls: [[(cls, corners(8,3), score), ...], ...].
    Raises AssertionError, as the JAX parse does, when a scene keeps no
    box (every box of it removed as empty).
    """
    num_class = config_dict["dataset_config"].num_class
    return proposal_lists(pack_predictions(ep, config_dict), num_class, config_dict)


def proposal_lists(packed: np.ndarray, num_class: int, config_dict):
    """The per-scene proposal lists from one host copy, (B, K, 24 + C + 4)
    float32: corners, the class and objectness logits, the keep mask and
    the argmax class the NMS gated on. The proposals' scores are
    ``softmax_np``'s, computed here, so that they are the NumPy parse's bit
    for bit and AP ranks them as it does. With ``per_class_proposal`` each
    kept box over ``conf_thresh`` gives one proposal a class, class by
    class, scored prob x objectness; else one, of its argmax class, scored
    objectness (JAX ``ap_helper.py:137-157``)."""
    b, k = packed.shape[:2]
    corners = packed[..., :24].reshape(b, k, 8, 3)
    probs = softmax_np(packed[..., 24:24 + num_class])
    obj = softmax_np(packed[..., 24 + num_class:26 + num_class])[..., 1]
    keep = packed[..., 26 + num_class] > 0
    sem = packed[..., 27 + num_class].astype(np.int64)
    if not keep.any(1).all():  # the JAX parse's `assert len(pick) > 0`, kept under -O
        raise AssertionError("a scene without any valid box")
    scene, box = np.nonzero(keep & (obj > config_dict["conf_thresh"]))
    bounds = np.searchsorted(scene, np.arange(b + 1))
    out = []
    for i in range(b):
        js = box[bounds[i]:bounds[i + 1]]
        boxes = list(corners[i, js])  # one (8, 3) array a box, shared by its classes
        if config_dict["per_class_proposal"]:
            score = (probs[i, js] * obj[i, js, None]).T  # (C, m) float32 products, as NumPy's
            cur = []
            for c in range(num_class):
                cur.extend(zip(repeat(c), boxes, score[c]))
            out.append(cur)
        else:
            out.append(list(zip(sem[i, js].tolist(), boxes, obj[i, js])))
    return out


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
        nonempty = nonempty_boxes(corners, _need_clouds(ep)).astype(np.float64)

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


def groundtruths2corners3d(batch, config_dict):
    """Decode GT labels to camera-frame corners (B, MAX_NUM_OBJ, 8, 3) and
    depth-frame params (B, MAX_NUM_OBJ, 7) (ap_helper.py:238-275),
    vectorized. Rows with box_label_mask==0 keep zero params/corners like
    the reference's `continue`."""
    cfg = config_dict["dataset_config"]
    center = _to_np(batch["center_label"])[..., 0:3]
    heading_class = _to_np(batch["heading_class_label"])
    heading_residual = _to_np(batch["heading_residual_label"])
    size_class = _to_np(batch["size_class_label"])
    size_residual = _to_np(batch["size_residual_label"])
    mask = _to_np(batch["box_label_mask"])

    heading_angle = cfg.class2angle(heading_class, heading_residual)
    box_size = cfg.mean_size_arr[size_class] + size_residual
    corners = get_3d_box_batch_np(
        box_size, heading_angle, flip_axis_to_camera(center)
    ).astype(np.float32)
    params = np.zeros(center.shape[:2] + (7,), dtype=np.float32)
    params[..., 0:3] = center
    params[..., 3:6] = np.where(mask[..., None] == 1, box_size, 0.0)
    params[..., 6] = np.where(mask == 1, heading_angle, 0.0)
    corners = np.where(mask[..., None, None] == 1, corners, 0.0)
    return corners, params


@trace.span("eval.parse_groundtruths")
def parse_groundtruths(batch, config_dict):
    """GT corners list (ap_helper.py:224-290), vectorized decode."""
    mask = _to_np(batch["box_label_mask"])
    sem = _to_np(batch["sem_cls_label"])
    corners, _ = groundtruths2corners3d(batch, config_dict)

    batch_gt_map_cls = []
    for i in range(corners.shape[0]):
        batch_gt_map_cls.append(
            [
                (int(sem[i, j]), corners[i, j])
                for j in range(corners.shape[1])
                if mask[i, j] == 1
            ]
        )
    return batch_gt_map_cls


def align_predictions_groundtruths(batch_pred_corners_3d, batch_gt_corners_3d,
                                   batch, iou_threshold=0.5):
    """For each predicted box, the best-overlapping GT box, a 0/1 fitness
    flag (IoU >= threshold), and its semantic class (ap_helper.py:294-338).

    batch_pred_corners_3d: (B, K, 8, 3) upright-camera corners;
    batch_gt_corners_3d: (B, MAX_NUM_OBJ, 8, 3); batch provides
    box_label_mask and sem_cls_label.
    """
    from .box3d_iou_np import box3d_iou

    bsize, num_proposal = batch_pred_corners_3d.shape[:2]
    box_label_mask = _to_np(batch["box_label_mask"])
    sem_cls_label = _to_np(batch["sem_cls_label"])

    batch_sem_cls_labels = np.zeros((bsize, num_proposal, 1), dtype=np.int64)
    batch_confidence_scores = np.zeros((bsize, num_proposal, 1), np.float32)
    batch_gt_corners_3d_aligned = np.zeros(
        (bsize, num_proposal, 8, 3), dtype=np.float32)

    for i in range(bsize):
        cur_mask = np.nonzero(box_label_mask[i])
        gt_corners_3d = batch_gt_corners_3d[i][cur_mask]
        gt_classes = sem_cls_label[i][cur_mask]
        for j in range(num_proposal):
            bb = batch_pred_corners_3d[i, j]
            iou_list = [box3d_iou(bb, bbgt)[0] for bbgt in gt_corners_3d]
            if iou_list:
                iou_list = np.array(iou_list)
                max_ind = np.argmax(iou_list)
                batch_gt_corners_3d_aligned[i, j] = gt_corners_3d[max_ind]
                batch_sem_cls_labels[i, j] = gt_classes[max_ind]
                if iou_list.max() >= iou_threshold:
                    batch_confidence_scores[i, j] = 1.0
    return (batch_gt_corners_3d_aligned, batch_confidence_scores,
            batch_sem_cls_labels)


def get_roi_ptcloud(inputs, batch_pred_boxes_params, enlarge_ratio=1.2,
                    num_point_roi=512, min_num_point=100, rng=None):
    """Crop + resample the scene cloud inside each (enlarged) predicted box
    (ap_helper.py:341-379). Returns ((B, K, num_point_roi, C) clouds,
    (B, K) nonempty mask; boxes with < min_num_point points stay zero with
    mask 0)."""
    from ..data.pc_util import random_sampling
    from ..data.sunrgbd_calib import extract_pc_in_box3d
    from ..geometry.boxes import get_3d_box_np

    batch_pc = _to_np(inputs["point_clouds"])
    batch_pred_boxes_params = _to_np(batch_pred_boxes_params)
    bsize, k = batch_pred_boxes_params.shape[:2]
    batch_pc_roi = np.zeros(
        (bsize, k, num_point_roi, batch_pc.shape[2]), dtype=np.float32)
    nonempty_roi_mask = np.ones((bsize, k))

    for i in range(bsize):
        pc = batch_pc[i]
        for j in range(k):
            box_params = batch_pred_boxes_params[i, j]
            center_upright_camera = flip_axis_to_camera(box_params[0:3])
            box3d = get_3d_box_np(
                box_params[3:6] * enlarge_ratio, box_params[6],
                center_upright_camera)
            box3d = flip_axis_to_depth(box3d)
            pc_in_box, _ = extract_pc_in_box3d(pc, box3d)
            if len(pc_in_box) >= min_num_point:
                batch_pc_roi[i, j] = random_sampling(
                    pc_in_box, num_point_roi, rng=rng)
            else:
                nonempty_roi_mask[i, j] = 0
    return batch_pc_roi, nonempty_roi_mask


class APCalculator:
    """AP accumulator (ap_helper.py:382-435)."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None, processes=1):
        # processes=1 (serial) by default, as the JAX package has it; the
        # reference's 10-process pool (ap_helper.py:430) is opt-in.
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.processes = processes
        self.reset()

    @trace.span("eval.ap_step")
    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for i in range(len(batch_pred_map_cls)):
            self.gt_map_cls[self.scan_cnt] = batch_gt_map_cls[i]
            self.pred_map_cls[self.scan_cnt] = batch_pred_map_cls[i]
            self.scan_cnt += 1

    def compute_metrics(self):
        rec, _, ap = eval_det_multiprocessing(
            self.pred_map_cls, self.gt_map_cls, ovthresh=self.ap_iou_thresh,
            get_iou_func=get_iou_obb, processes=self.processes,
        )
        ret = {}
        for key in sorted(ap.keys()):
            clsname = self.class2type_map[key] if self.class2type_map else str(key)
            ret["%s Average Precision" % clsname] = ap[key]
        ret["mAP"] = np.mean(list(ap.values())) if ap else 0.0
        rec_list = []
        for key in sorted(ap.keys()):
            clsname = self.class2type_map[key] if self.class2type_map else str(key)
            try:
                ret["%s Recall" % clsname] = rec[key][-1]
                rec_list.append(rec[key][-1])
            except (TypeError, IndexError):
                ret["%s Recall" % clsname] = 0
                rec_list.append(0)
        ret["AR"] = np.mean(rec_list) if rec_list else 0.0
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0


def eval_config_dict(cfg, use_iou_for_nms: bool = True, conf_thresh: float = 0.05) -> dict:
    """The reference eval settings (``iou3dmatch_tpu/cli/common.py:17-36``,
    train.py:263-275): 3D NMS, class-aware, IoU 0.25, per-class proposals;
    IoU-guided NMS as ``run_eval.sh`` runs it."""
    return {
        "dataset_config": cfg,
        "remove_empty_box": False,
        "use_3d_nms": True,
        "nms_iou": 0.25,
        "use_old_type_nms": False,
        "cls_nms": True,
        "use_iou_for_nms": use_iou_for_nms,
        "per_class_proposal": True,
        "conf_thresh": conf_thresh,
    }
