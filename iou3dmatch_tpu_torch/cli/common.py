"""Driver plumbing shared by the entry points: the eval config dict, metric
averaging and the eval epoch.

Counterpart of ``iou3dmatch_tpu/cli/common.py:17-36`` and ``:161-226``
(reference pretrain.py:107-232, train.py:263-275 and 378-535). The data
loaders are not ported yet: ``evaluate`` takes any iterable of batch dicts
of tensors.
"""
import torch

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
