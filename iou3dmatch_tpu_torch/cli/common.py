"""Driver plumbing shared by the entry points: dataset construction, the
eval config dict, metric averaging, the eval epoch, the drivers' device and
startup refusals, and their training loop.

Counterpart of ``iou3dmatch_tpu/cli/common.py`` (reference
pretrain.py:107-232, train.py:91-275 and 378-535) and of the loop the JAX
drivers each write out (``cli/pretrain.py:174-235``, ``cli/train.py:255-322``).
``evaluate`` takes any iterable of batch dicts of tensors, such as
``map(stage_batch, loader)`` of a ``data/loader.py::DataLoader``.
"""
import functools
import os
import time

import numpy as np
import torch

from ..data.config import get_config
from ..data.loader import prefetch
from ..data.scannet import (ScannetDetectionDataset, ScannetSSLLabeledDataset,
                            ScannetSSLUnlabeledDataset)
from ..data.sunrgbd import (SunrgbdDetectionVotesDataset, SunrgbdSSLLabeledDataset,
                            SunrgbdSSLUnlabeledDataset)
from ..data.staging import stage_batch
from ..data.synthetic import SyntheticDataset
from ..eval.ap_helper import APCalculator, parse_groundtruths, parse_predictions
from ..eval.iou_opt import iou_optimize
from ..parallel import distributed
from ..train import checkpoint
from ..train.schedules import get_bn_momentum, get_lr
from ..utils import dump_helper
from ..utils.tb_writer import Visualizer


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
    With ``dump_dir``, the first batch's PLYs go there
    (``utils/dump_helper.py::dump_results``, JAX ``cli/common.py:212-215``).

    Returns (metric_means, {thresh: metrics_dict}, map_sum).
    """
    calculators = {t: APCalculator(t, cfg.class2type) for t in ap_iou_thresholds}
    averager = MetricAverager()
    for bi, batch in enumerate(eval_loader):
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
        if dump_dir is not None and bi == 0:
            dump_helper.dump_results(out, batch, dump_dir, cfg)

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


def driver_device(args) -> torch.device:
    """The drivers' startup checks, before any data or model: the device
    ``--device`` names, the card's first by default. Raises when CUDA is
    asked for and absent: nothing falls back to the CPU. Every flag of the
    JAX drivers runs on the card, ``--num_target`` at any count (NMS past
    1,024 proposals a scene takes its global-matrix path, ``ops/nms.py``).
    Under torchrun (``WORLD_SIZE`` > 1) it joins the process group
    (``parallel/distributed.py``) and returns the rank's device, of
    ``--device``'s type."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dev = distributed.initialize_distributed(device_type=dev.type, logger=lambda line: None).device
    return dev


def driver_logger(args, group):
    """The drivers' log (``utils/logger.py``) on rank 0; on the other ranks
    a logger that drops every line: only rank 0 logs."""
    from ..utils.logger import Logger

    return Logger(args.log_dir) if group.rank == 0 else _Silent()


class _Silent:
    def __call__(self, msg: str) -> None:
        pass

    def log_best(self, msg: str, filename: str = "best.txt") -> None:
        pass

    def close(self) -> None:
        pass


def model_precision(args) -> dict:
    """``build_votenet``'s precision arguments from ``--bf16`` and
    ``--f32_gridconv``, as the JAX drivers pass them (``cli/train.py:188-189``)."""
    return {"compute_dtype": "bfloat16" if args.bf16 else None,
            "f32_gridconv": args.f32_gridconv}


def log_precision(args, logger) -> None:
    """The compute dtype line: the shared MLPs' dtype, and GridConv's where
    ``--f32_gridconv`` keeps it apart; parameters are float32 always."""
    if not args.bf16:
        logger("compute dtype: float32")
    else:
        logger("compute dtype: bfloat16 (GridConv "
               + ("float32" if args.f32_gridconv else "bfloat16") + "), parameters float32")


def log_device(dev: torch.device, logger, group=None) -> None:
    """The device line; the process group's line under one; and one more
    when more cards are visible than one process uses."""
    logger(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    if group is not None and group.pg is not None:
        logger(distributed.describe(group))
    elif dev.type == "cuda" and torch.cuda.device_count() > 1:
        logger(f"{torch.cuda.device_count()} cards visible; this driver uses {dev} only "
               "(start it under torchrun for data parallelism over them)")


def staged(loader, dev: torch.device):
    """The loader's next epoch, each batch staged onto ``dev`` in one copy
    (``data/staging.py``), a batch ahead in a thread."""
    return prefetch(map(functools.partial(stage_batch, device=dev), iter(loader)))


def _write_trace(profiler, log_dir: str, logger) -> None:
    profiler.stop()
    os.makedirs(os.path.join(log_dir, "profile"), exist_ok=True)
    profiler.export_chrome_trace(os.path.join(log_dir, "profile", "trace.json"))
    logger(f"profiler trace written to {log_dir}/profile")


def train_epochs(args, state, step, loader, eval_epoch, logger, ckpt_path: str,
                 start_epoch: int, dev: torch.device, group=None) -> None:
    """The drivers' loop (pretrain.py:310-406, train.py:305-371 and
    569-611 of the reference), epochs ``start_epoch`` to ``args.max_epoch``:
    per epoch the lr and BN momentum schedules and their header line; per
    step ``step(state, batch, lr, bn_momentum)`` on the staged batch and one
    copy of its metrics to the host, a non-finite loss writing
    ``nan_checkpoint.tar`` and raising ``FloatingPointError``, and every
    ``print_interval`` steps the means of the loss, acc, ratio and value
    metrics logged and all of them written to TensorBoard
    (``<log_dir>/tb/train``); then ``checkpoint.tar`` every ``ckpt_interval``
    epochs and at the last, ``checkpoint_{epoch}.tar`` every
    ``save_interval``, and every ``eval_interval`` ``eval_epoch()`` (which
    returns ``evaluate``'s triple), its mAPs to ``<log_dir>/tb/eval`` and,
    on a new best mAP sum, ``best_checkpoint_sum.tar`` and ``best.txt``.
    ``--profile_steps`` steps from the first epoch's second go to a
    ``torch.profiler`` Chrome trace in ``<log_dir>/profile``.

    Under a data ``group`` (``parallel/``) every rank runs the loop on its
    rows, ``step`` returns the global metrics, so every rank takes the
    same branch at a non-finite loss; rank 0 alone logs, writes TensorBoard
    and the trace, saves checkpoints and runs the eval, and the others wait
    for it at a barrier after each write and eval."""
    group = group or distributed.DataGroup()
    lead = group.rank == 0
    lr_steps = [int(x) for x in args.lr_decay_steps.split(",")]
    lr_rates = [float(x) for x in args.lr_decay_rates.split(",")]
    viz_train = Visualizer(args.log_dir, "train") if lead else None
    viz_eval = Visualizer(args.log_dir, "eval") if lead else None
    try:
        best_map_sum = -1.0
        global_step = state.step
        for epoch in range(start_epoch, args.max_epoch):
            lr = get_lr(epoch, args.learning_rate, lr_steps, lr_rates)
            bn_mom = get_bn_momentum(epoch, args.bn_decay_step, args.bn_decay_rate)
            logger(f"**** EPOCH {epoch:03d} ****  lr {lr:.6f}  bn_momentum {bn_mom:.4f}")
            averager = MetricAverager()
            profiler = None
            t0 = time.time()
            for bi, batch in enumerate(staged(loader, dev)):
                if args.profile_steps and epoch == start_epoch and bi == 1 and lead:
                    profiler = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                        if dev.type == "cuda" else [torch.profiler.ProfilerActivity.CPU])
                    profiler.start()
                metrics = fetch_metrics(step(state, batch, lr, bn_mom))  # one copy, one wait
                loss_val = metrics["loss"]
                if not np.isfinite(loss_val):
                    checkpoint.save(os.path.join(args.log_dir, "nan_checkpoint.tar"), state, epoch)
                    distributed.barrier(group)
                    logger(f"FATAL: non-finite loss {loss_val} at epoch {epoch} "
                           f"batch {bi}; state saved to nan_checkpoint.tar")
                    raise FloatingPointError("non-finite training loss")
                averager.update(metrics)
                if profiler is not None and bi == args.profile_steps:
                    _write_trace(profiler, args.log_dir, logger)
                    profiler = None
                global_step += 1
                if (bi + 1) % args.print_interval == 0:
                    means = averager.means()
                    logger(f" batch {bi + 1:04d} " + " ".join(
                        f"{k}: {v:.4f}" for k, v in sorted(means.items())
                        if "loss" in k or "acc" in k or "ratio" in k or "value" in k))
                    if lead:
                        viz_train.log_scalars(means, global_step)
                    averager.reset()
            if profiler is not None:  # the epoch ended first
                _write_trace(profiler, args.log_dir, logger)
            logger(f"epoch time: {time.time() - t0:.1f}s")

            if (epoch + 1) % args.ckpt_interval == 0 or epoch + 1 == args.max_epoch:
                checkpoint.save(ckpt_path, state, epoch + 1)
                distributed.barrier(group)
            if (epoch + 1) % args.save_interval == 0:
                checkpoint.save(os.path.join(args.log_dir, f"checkpoint_{epoch + 1}.tar"),
                                state, epoch + 1)
                distributed.barrier(group)
            if args.eval_interval > 0 and (epoch + 1) % args.eval_interval == 0:
                if not lead:
                    distributed.barrier(group)
                    continue
                _, ap_results, map_sum = eval_epoch()
                viz_eval.log_scalars({f"mAP_{t}": m["mAP"] for t, m in ap_results.items()},
                                     global_step)
                if map_sum > best_map_sum:
                    best_map_sum = map_sum
                    checkpoint.save(os.path.join(args.log_dir, "best_checkpoint_sum.tar"),
                                    state, epoch + 1, loss=map_sum)
                    logger.log_best(f"epoch {epoch + 1}: mAP sum {map_sum:.4f}")
                distributed.barrier(group)
    finally:
        for viz in (viz_train, viz_eval):
            if viz is not None:
                viz.close()
