"""Driver plumbing shared by the entry points: dataset construction, the
eval config dict, metric averaging and the eval epoch.

Counterpart of ``iou3dmatch_tpu/cli/common.py`` (reference
pretrain.py:107-232, train.py:91-275 and 378-535). ``evaluate`` takes any
iterable of batch dicts of tensors, such as ``map(stage_batch, loader)``
of a ``data/loader.py::DataLoader``.
"""
import os

import torch

from ..data.config import get_config
from ..data.scannet import (ScannetDetectionDataset, ScannetSSLLabeledDataset,
                            ScannetSSLUnlabeledDataset)
from ..data.sunrgbd import (SunrgbdDetectionVotesDataset, SunrgbdSSLLabeledDataset,
                            SunrgbdSSLUnlabeledDataset)
from ..data.synthetic import SyntheticDataset
from ..eval.ap_helper import APCalculator, parse_groundtruths, parse_predictions
from ..eval.iou_opt import iou_optimize


def make_config_dict(cfg, args):
    """CONFIG_DICT with the reference eval defaults (train.py:263-275), the
    knobs read from ``args`` where it has them."""
    return {
        "dataset_config": cfg,
        "remove_empty_box": False,
        "use_3d_nms": True,
        "nms_iou": 0.25,
        "use_old_type_nms": False,
        "cls_nms": True,
        "use_iou_for_nms": bool(getattr(args, "use_iou_for_nms", False)),
        "per_class_proposal": True,
        "conf_thresh": getattr(args, "conf_thresh", 0.05),
        # carried for CONFIG_DICT parity with pretrain.py:231; the reference
        # never reads it
        "iou_weight": getattr(args, "iou_weight", 1.0),
        "obj_threshold": getattr(args, "obj_threshold", 0.9),
        "cls_threshold": getattr(args, "cls_threshold", 0.9),
        "use_lhs": True,
        "iou_threshold": getattr(args, "iou_threshold", 0.25),
    }


def _data_root(args, sub):
    root = getattr(args, "data_path", None)
    return os.path.join(root, sub) if root else sub


def _sunrgbd_dir(args, split):
    """v1 (default) or v2 box-label dumps (--use_sunrgbd_v2, mirroring
    use_v1=(not FLAGS.use_sunrgbd_v2) at pretrain.py:137/train.py:119)."""
    ver = "v2" if getattr(args, "use_sunrgbd_v2", False) else "v1"
    return f"sunrgbd_pc_bbox_votes_50k_{ver}_{split}"


def build_supervised_datasets(args):
    """(train_ds, eval_ds, cfg) for stage 1 from the drivers' ``args``
    (``dataset``, ``data_path``, ``labeled_sample_list``, ``num_point``,
    ``no_height``, ``use_color``, ``use_sunrgbd_v2``), or synthetic scenes
    with ``args.synthetic`` (``synthetic_scenes`` of them): the offline
    dumps need a manual download (README.md:83-117 of the reference)."""
    cfg = get_config(args.dataset)
    if getattr(args, "synthetic", False):
        train_ds = SyntheticDataset(args.dataset, num_scenes=args.synthetic_scenes,
                                    num_points=args.num_point, seed=1)
        eval_ds = SyntheticDataset(args.dataset, num_scenes=max(args.synthetic_scenes // 4, 2),
                                   num_points=args.num_point, seed=2)
        return train_ds, eval_ds, cfg

    feats = dict(use_height=not args.no_height, use_color=args.use_color)
    if args.dataset == "scannet":
        data_path = _data_root(args, "scannet_train_detection_data")
        split_dir = _data_root(args, "meta_data")
        train_ds = ScannetDetectionDataset(
            data_path, split_dir, "train", labeled_sample_list=args.labeled_sample_list,
            num_points=args.num_point, augment=True, **feats)
        eval_ds = ScannetDetectionDataset(
            data_path, split_dir, "val", num_points=args.num_point, augment=False, **feats)
    else:
        data_path = _data_root(args, _sunrgbd_dir(args, "train"))
        split_dir = _data_root(args, "sunrgbd_trainval")
        train_ds = SunrgbdDetectionVotesDataset(
            data_path, split_dir, labeled_sample_list=args.labeled_sample_list,
            num_points=args.num_point, augment=True, **feats)
        eval_ds = SunrgbdDetectionVotesDataset(
            _data_root(args, _sunrgbd_dir(args, "val")), num_points=args.num_point,
            augment=False, **feats)
    return train_ds, eval_ds, cfg


def build_ssl_datasets(args):
    """(labeled_ds, unlabeled_ds, eval_ds, cfg) for stage 2, from the
    ``args`` of ``build_supervised_datasets``; with ``args.view_stats`` the
    unlabeled scenes carry their raw-frame GT."""
    cfg = get_config(args.dataset)
    load_labels = bool(getattr(args, "view_stats", False))
    if getattr(args, "synthetic", False):
        labeled = SyntheticDataset(args.dataset, num_scenes=args.synthetic_scenes,
                                   num_points=args.num_point, ssl=True, labeled=True, seed=1)
        unlabeled = SyntheticDataset(args.dataset, num_scenes=args.synthetic_scenes * 2,
                                     num_points=args.num_point, ssl=True, labeled=False,
                                     seed=3, load_labels=load_labels)
        eval_ds = SyntheticDataset(args.dataset, num_scenes=max(args.synthetic_scenes // 4, 2),
                                   num_points=args.num_point, seed=2)
        return labeled, unlabeled, eval_ds, cfg

    feats = dict(use_height=not args.no_height, use_color=args.use_color)
    if args.dataset == "scannet":
        data_path = _data_root(args, "scannet_train_detection_data")
        split_dir = _data_root(args, "meta_data")
        labeled = ScannetSSLLabeledDataset(
            data_path, split_dir, args.labeled_sample_list, num_points=args.num_point,
            augment=True, **feats)
        unlabeled = ScannetSSLUnlabeledDataset(
            data_path, split_dir, args.labeled_sample_list, num_points=args.num_point,
            augment=True, load_labels=load_labels, **feats)
        eval_ds = ScannetDetectionDataset(
            data_path, split_dir, "val", num_points=args.num_point, augment=False, **feats)
    else:
        data_path = _data_root(args, _sunrgbd_dir(args, "train"))
        split_dir = _data_root(args, "sunrgbd_trainval")
        labeled = SunrgbdSSLLabeledDataset(
            data_path, split_dir, args.labeled_sample_list, num_points=args.num_point,
            augment=True, **feats)
        unlabeled = SunrgbdSSLUnlabeledDataset(
            data_path, split_dir, args.labeled_sample_list, num_points=args.num_point,
            augment=True, load_labels=load_labels, **feats)
        eval_ds = SunrgbdDetectionVotesDataset(
            _data_root(args, _sunrgbd_dir(args, "val")), num_points=args.num_point,
            augment=False, **feats)
    return labeled, unlabeled, eval_ds, cfg


def fetch_metrics(metrics: dict) -> dict:
    """Scalar metric tensors -> host floats in one copy (one stack on their
    device, so one wait for the card)."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).cpu().numpy()
    return dict(zip(keys, vals.tolist()))


class MetricAverager:
    """Running means of every scalar metric, like the reference's
    stat_dict accumulation (train.py:356-369)."""

    def __init__(self):
        self.sums = {}
        self.count = 0

    def update(self, metrics):
        for k, v in metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
        self.count += 1

    def means(self):
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}

    def reset(self):
        self.sums, self.count = {}, 0


def evaluate(model, cfg, eval_loader, config_dict, logger, eval_loss,
             ap_iou_thresholds=(0.25, 0.5), opt_rate=0.0, opt_step=0, dump_dir=None):
    """Eval epoch: forward with the eval loss, optional test-time IoU
    optimisation, the parse of predictions and GT, VOC AP
    (evaluate_one_epoch, train.py:378-428; evaluate_with_opt :431-535).

    ``eval_loader`` yields batch dicts of tensors: ``point_clouds`` and the
    GT labels ``get_loss`` and ``parse_groundtruths`` read. ``eval_loss`` is
    ``train/steps.py::make_eval_loss(model, cfg)``, and ``model`` the model
    it runs, whose GridConv the optimisation re-runs. ``logger`` takes lines.

    Returns (metric_means, {thresh: metrics_dict}, map_sum).
    """
    if dump_dir is not None:
        raise NotImplementedError("dump_dir needs utils/dump_helper.py, not ported yet")
    calculators = {t: APCalculator(t, cfg.class2type) for t in ap_iou_thresholds}
    averager = MetricAverager()
    for batch in eval_loader:
        labels = {k: v for k, v in batch.items() if k != "point_clouds"}
        out, metrics = eval_loss(batch["point_clouds"], labels)
        if opt_step > 0:
            out = iou_optimize(model, out, opt_rate, opt_step)
        averager.update(fetch_metrics(metrics))
        # the batch inputs the parse may need (remove_empty_box)
        out = dict(out)
        out.setdefault("point_clouds", batch["point_clouds"])
        pred_map_cls = parse_predictions(out, config_dict)
        gt_map_cls = parse_groundtruths(batch, config_dict)
        for calc in calculators.values():
            calc.step(pred_map_cls, gt_map_cls)

    means = averager.means()
    for k in sorted(means):
        logger(f"eval mean {k}: {means[k]:.6f}")
    ap_results, map_sum = {}, 0.0
    for t, calc in calculators.items():
        m = calc.compute_metrics()
        ap_results[t] = m
        map_sum += m["mAP"]
        logger(f"eval mAP@{t}: {m['mAP']:.4f}  AR@{t}: {m['AR']:.4f}")
    return means, ap_results, map_sum
