"""Stage-1 supervised pretraining driver.

Counterpart of ``iou3dmatch_tpu/cli/pretrain.py`` (reference pretrain.py:
flags :41-70, loop :310-406): the same flags, defaults, schedules, log and
checkpoint layout. Forked workers load each batch (``data/loader.py``), one
copy stages it onto the card a batch ahead (``data/staging.py``), and
``train/steps.py::make_pretrain_step`` trains on it; the loop is
``cli/common.py::train_epochs``.

Where it differs from the JAX driver (ROADMAP Queue 3):

- ``--device`` (default ``cuda``, the first card) takes the place of
  ``--platform``. Without CUDA it raises unless ``--device cpu`` is given.
- On the card, ``--num_target`` above ``ops/nms.py::GLOBAL_MAX_BOXES`` (14,016) is refused
  at startup.
- ``--profile_steps`` writes a ``torch.profiler`` Chrome trace, with the
  program's ranges (the step and its phases) and its counters a step logged.
- One process, as JAX's pretrain driver has no mesh: under torchrun with
  ``WORLD_SIZE`` > 1 it refuses to start.
- ``--model groupfree`` trains Group-Free-3D with the IoU branch
  (``models/groupfree.py``, which the JAX package does not have) at
  ``--num_decoder_layers`` and ``--width`` (by default its largest ScanNet
  model's, L12-w2x), with its loss
  (``losses/groupfree.py``) and AdamW, the decoder at a tenth of the lr;
  ``--eval`` evaluates it, with ``--opt_step`` steps of test-time IoU
  optimisation at ``--opt_rate``. It runs in float32 with KPS sampling:
  ``--bf16``, ``--cluster_sampling`` and ``--vote_factor`` are VoteNet's.

Run:  python -m iou3dmatch_tpu_torch.cli.pretrain --dataset scannet \\
          --labeled_sample_list scannetv2_train_0.1.txt --log_dir log_scannet
Group-Free-3D L12-O256-w2x: add --model groupfree --num_target 256
--num_point 50000 --learning_rate 0.006 --weight_decay 0.0005.
On the CPU, with no dataset on disk: add --synthetic --tiny --device cpu.
"""
import argparse
import os
import shutil

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="scannet", choices=["scannet", "sunrgbd"])
    p.add_argument("--model", default="votenet", choices=["votenet", "groupfree"],
                   help="VoteNet-IoU, or Group-Free-3D with the IoU branch")
    p.add_argument("--num_decoder_layers", type=int, default=12,
                   help="Group-Free-3D's decoder layers (its largest ScanNet model's)")
    p.add_argument("--width", type=int, default=2,
                   help="Group-Free-3D's backbone width multiplier (its largest model's)")
    p.add_argument("--log_dir", default="log_pretrain")
    p.add_argument("--data_path", default=None, help="root holding the dataset dumps")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--labeled_sample_list", default=None)
    p.add_argument("--num_point", type=int, default=40000)
    p.add_argument("--num_target", type=int, default=None,
                   help="proposals [default: 128, or 16 with --tiny; explicit wins]; at most "
                        "1024 on the card (ops/nms.py MAX_BOXES)")
    p.add_argument("--cluster_sampling", default="seed_fps",
                   choices=["vote_fps", "seed_fps", "random"])
    p.add_argument("--max_epoch", type=int, default=901)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_decay_steps", default="400,600,800")
    p.add_argument("--lr_decay_rates", default="0.1,0.1,0.1")
    p.add_argument("--bn_decay_step", type=int, default=20)
    p.add_argument("--bn_decay_rate", type=float, default=0.5)
    p.add_argument("--no_height", action="store_true")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_sunrgbd_v2", action="store_true",
                   help="V2 box labels for SUN RGB-D (pretrain.py:62)")
    p.add_argument("--vote_factor", type=int, default=1,
                   help="votes generated per seed (pretrain.py:47)")
    p.add_argument("--iou_weight", type=float, default=1.0,
                   help="kept for CONFIG_DICT parity (pretrain.py:65,231); "
                        "the reference never consumes it")
    p.add_argument("--ap_iou_thresh", type=float, default=0.25)
    p.add_argument("--eval_interval", type=int, default=50)
    p.add_argument("--save_interval", type=int, default=200)
    p.add_argument("--print_interval", type=int, default=10)
    p.add_argument("--ckpt_interval", type=int, default=1,
                   help="write the resume checkpoint every N epochs (always at the final "
                        "epoch); trades resume granularity for wall clock, training "
                        "numerics are unaffected")
    p.add_argument("--use_iou_for_nms", action="store_true")
    p.add_argument("--dump_results", action="store_true")
    p.add_argument("--dump_dir", default=None,
                   help="where --dump_results PLYs go [default: <log_dir>/dump]")
    p.add_argument("--overwrite", action="store_true",
                   help="confirm-and-wipe an existing log dir (pretrain.py:97-105)")
    p.add_argument("--eval", action="store_true", help="evaluate only, no training")
    p.add_argument("--opt_step", type=int, default=0,
                   help="--eval: steps of test-time IoU optimisation (eval/iou_opt.py)")
    p.add_argument("--opt_rate", type=float, default=5e-4,
                   help="--eval: the IoU optimisation's step size")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated scenes (no dataset dumps needed)")
    p.add_argument("--synthetic_scenes", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny backbone (CI smoke)")
    p.add_argument("--device", default="cuda",
                   help="torch device [default: cuda, the first card]; raises without CUDA "
                        "unless --device cpu (the JAX driver's --platform)")
    p.add_argument("--f32_gridconv", action="store_true",
                   help="keep the GridConv IoU branch in float32 under --bf16 (no effect "
                        "without it)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed precision: the SA, FP and GridConv shared MLPs compute "
                        "in bfloat16; parameters, BN statistics and heads stay float32")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="write a torch.profiler Chrome trace of this many steps (epoch 0, "
                        "from its second step) into <log_dir>/profile, with the program's "
                        "ranges (the step and its phases); log its counters a step")
    return p.parse_args(argv)


def main(argv=None):
    """Trains, or with ``--eval`` evaluates and returns ``evaluate``'s
    (metric means, {threshold: metrics}, mAP sum)."""
    args = parse_args(argv)
    if args.model == "groupfree" and (args.bf16 or args.cluster_sampling != "seed_fps"
                                      or args.vote_factor != 1):
        raise SystemExit("--model groupfree runs in float32 and samples its queries by KPS: "
                         "--bf16, --cluster_sampling and --vote_factor are VoteNet's")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit(f"cli/pretrain.py runs in one process (WORLD_SIZE is "
                         f"{os.environ['WORLD_SIZE']}): the JAX pretrain driver has no mesh; "
                         "data parallelism is cli/train.py's")
    from ..data.loader import DataLoader
    from ..losses import get_groupfree_eval_loss, get_groupfree_loss
    from ..models.factory import build_groupfree, build_votenet
    from ..train import checkpoint
    from ..train.state import create_train_state
    from ..train.steps import make_eval_loss, make_pretrain_step
    from ..utils.logger import Logger
    from . import common

    dev = common.driver_device(args)
    dump_dir = args.dump_dir or os.path.join(args.log_dir, "dump")
    if os.path.exists(args.log_dir) and args.overwrite:
        # the reference's confirm (pretrain.py:97-105)
        print(f"Log folder {args.log_dir} already exists. Are you sure to overwrite? (Y/N)")
        c = input()
        if c in ("n", "N"):
            print("Exiting..")
            return None
        elif c in ("y", "Y"):
            print("Overwrite the files in the log and dump folders...")
            shutil.rmtree(args.log_dir, ignore_errors=True)
            shutil.rmtree(dump_dir, ignore_errors=True)
        # any other answer continues into the existing folder, as the reference does

    logger = Logger(args.log_dir)
    logger(str(args))
    common.log_device(dev, logger)
    common.log_precision(args, logger)
    train_ds, eval_ds, cfg = common.build_supervised_datasets(args)
    logger(f"train scenes: {len(train_ds)}  eval scenes: {len(eval_ds)}")
    # the loaders fork their workers before the model touches the card
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              num_workers=args.num_workers, seed=args.seed)
    eval_loader = None
    try:
        if len(train_loader) == 0:
            raise SystemExit(
                f"batch_size {args.batch_size} > {len(train_ds)} train scenes: "
                "zero batches per epoch (drop_last) — shrink --batch_size")
        eval_loader = DataLoader(eval_ds, args.batch_size, shuffle=False,
                                 drop_last=False, num_workers=args.num_workers)

        feature_dim = (0 if args.no_height else 1) + (3 if args.use_color else 0)
        generator = torch.Generator().manual_seed(args.seed)
        if args.model == "groupfree":
            model, _ = build_groupfree(
                args.dataset, num_proposal=args.num_target,
                num_decoder_layers=args.num_decoder_layers, width=args.width,
                input_feature_dim=feature_dim, tiny=args.tiny, device=dev, generator=generator)
            train_loss, eval_loss_fn = get_groupfree_loss, get_groupfree_eval_loss
        else:
            model, _ = build_votenet(
                args.dataset, num_proposal=args.num_target, input_feature_dim=feature_dim,
                sampling=args.cluster_sampling, tiny=args.tiny, vote_factor=args.vote_factor,
                device=dev, generator=generator, **common.model_precision(args))
            train_loss = eval_loss_fn = None
        state = create_train_state(model, seed=args.seed + 1, weight_decay=args.weight_decay)

        start_epoch = 0
        ckpt_path = args.checkpoint_path or os.path.join(args.log_dir, "checkpoint.tar")
        if args.resume and os.path.exists(ckpt_path):
            start_epoch, _ = checkpoint.load(ckpt_path, state)
            logger(f"resumed from {ckpt_path} at epoch {start_epoch}")
        elif args.checkpoint_path and os.path.exists(args.checkpoint_path):
            checkpoint.load(args.checkpoint_path, state)
            logger(f"loaded weights from {args.checkpoint_path}")

        # random sampling's eval indices: a generator of their own, so that an
        # eval leaves the training draws (state.generator) where they were
        eval_loss = make_eval_loss(model, cfg,
                                   generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
                                   loss=eval_loss_fn)
        config_dict = common.make_config_dict(cfg, args)

        def eval_epoch(dump=None, opt_step=0):
            return common.evaluate(model, cfg, common.staged(eval_loader, dev), config_dict,
                                   logger, eval_loss, (0.25, 0.5), opt_rate=args.opt_rate,
                                   opt_step=opt_step, dump_dir=dump)

        if args.eval:
            return eval_epoch(dump_dir if args.dump_results else None, args.opt_step)
        common.train_epochs(args, state, make_pretrain_step(cfg, loss=train_loss), train_loader,
                            eval_epoch, logger, ckpt_path, start_epoch, dev)
        return None
    finally:
        for ld in (train_loader, eval_loader):
            if ld is not None:
                ld.close()
        logger.close()


if __name__ == "__main__":
    main()
