"""Stage-2 SSL (3DIoUMatch) training and evaluation driver.

Counterpart of ``iou3dmatch_tpu/cli/train.py`` (reference train.py: flags
:31-71, SSL loop :305-371, eval :378-535): mean-teacher training with
IoU-filtered pseudo labels, ``train/steps.py::make_ssl_step`` with every
knob, on labeled and unlabeled batches merged by ``SSLBatcher`` and staged
onto the card in one copy a batch ahead; the loop is
``cli/common.py::train_epochs``. ``--eval`` scores the student, or with
``--eval_use_ema`` the teacher, optionally after test-time IoU optimisation
(``--opt_step``, ``--opt_rate``).

Where it differs from the JAX driver (ROADMAP Queue 3):

- ``--device`` (default ``cuda``, the first card) takes the place of
  ``--platform``. Without CUDA it raises unless ``--device cpu`` is given.
- Data parallelism is a process a rank under ``torchrun`` (``torchrun
  --standalone --nproc_per_node N -m iou3dmatch_tpu_torch.cli.train ...``),
  in place of JAX's one process over a mesh: ``--batch_size`` is per
  device, the global batch ``bl·W + bu·W``; rank r trains on the rows
  ``[L_r; U_r]`` of the JAX loader's global batch, with the statistics and
  normalisers of the global batch (``parallel/``). Rank 0 alone logs,
  saves and evaluates, over the whole eval set at JAX's global eval batch.
  Run alone, the driver uses one card, the first by default.
- On the card, ``--num_target`` above ``ops/nms.py::GLOBAL_MAX_BOXES`` (14,016) is refused
  at startup.
- ``--profile_steps`` writes a ``torch.profiler`` Chrome trace, with the
  program's ranges (the step and its phases) and its counters a step logged.

Run:  python -m iou3dmatch_tpu_torch.cli.train --dataset scannet \\
          --labeled_sample_list scannetv2_train_0.1.txt \\
          --detector_checkpoint log_pretrain/best_checkpoint_sum.tar
Eval: add --eval --use_iou_for_nms (and --opt_step 10 --opt_rate R for
      test-time IoU optimisation, run_eval_opt_torch.sh).
"""
import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="scannet", choices=["scannet", "sunrgbd"])
    p.add_argument("--log_dir", default="log_ssl")
    p.add_argument("--data_path", default=None)
    p.add_argument("--detector_checkpoint", default=None,
                   help="stage-1 checkpoint loaded into student AND teacher; with --eval, a "
                        "file holding ema_model_state_dict loads its teacher as saved")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--labeled_sample_list", default=None)
    p.add_argument("--num_point", type=int, default=40000)
    p.add_argument("--num_target", type=int, default=None,
                   help="proposals [default: 128, or 16 with --tiny; explicit wins]; at most "
                        "1024 on the card (ops/nms.py MAX_BOXES)")
    p.add_argument("--cluster_sampling", default="seed_fps")
    p.add_argument("--max_epoch", type=int, default=1001)
    p.add_argument("--batch_size", default="4,8",
                   help="labeled,unlabeled scenes a step (train.py:47-48); per device: under "
                        "torchrun with W ranks the global batch is bl*W + bu*W")
    p.add_argument("--learning_rate", type=float, default=2e-3)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_decay_steps", default="400,600,800,900")
    p.add_argument("--lr_decay_rates", default="0.3,0.3,0.1,0.1")
    p.add_argument("--bn_decay_step", type=int, default=20)
    p.add_argument("--bn_decay_rate", type=float, default=0.5)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--unlabeled_loss_weight", type=float, default=2.0)
    p.add_argument("--obj_threshold", type=float, default=0.9)
    p.add_argument("--cls_threshold", type=float, default=0.9)
    p.add_argument("--iou_threshold", type=float, default=0.25)
    p.add_argument("--no_height", action="store_true")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_sunrgbd_v2", action="store_true",
                   help="V2 box labels for SUN RGB-D (train.py:41)")
    p.add_argument("--vote_factor", type=int, default=1,
                   help="votes generated per seed (train.py:43)")
    p.add_argument("--model", default="votenet",
                   help="kept for flag parity (train.py:32); the reference "
                        "imports VoteNet directly and never reads this")
    p.add_argument("--conf_thresh", type=float, default=0.05,
                   help="eval proposal confidence threshold (train.py:67,268)")
    p.add_argument("--ap_iou_thresh", type=float, default=0.25,
                   help="kept for flag parity (train.py:46); the reference "
                        "evaluates at the hardcoded [0.25, 0.5] (train.py:374)")
    p.add_argument("--eval_interval", type=int, default=25)
    p.add_argument("--save_interval", type=int, default=200)
    p.add_argument("--print_interval", type=int, default=10)
    p.add_argument("--ckpt_interval", type=int, default=1,
                   help="write the resume checkpoint every N epochs (always at the final "
                        "epoch); trades resume granularity for wall clock, training "
                        "numerics are unaffected")
    p.add_argument("--use_iou_for_nms", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval_use_ema", action="store_true",
                   help="evaluate the EMA teacher instead of the student")
    p.add_argument("--opt_step", type=int, default=0)
    p.add_argument("--opt_rate", type=float, default=5e-4)  # train.py:69
    p.add_argument("--dump_results", action="store_true")
    p.add_argument("--reference_exact_step", action="store_true",
                   help="reference-exact SSL step semantics, the default (the flag is kept "
                        "for script compatibility): the teacher on the full mixed batch "
                        "with the jittered-box GridConv pass, student jitter on every scene")
    p.add_argument("--fast_step", action="store_true",
                   help="pruned SSL step (run_train_fast_torch.sh): skip compute whose "
                        "outputs the reference discards (teacher labeled rows, teacher "
                        "jitter IoU, unlabeled student jitter); per-box numerics are "
                        "identical, only the train-mode BN batch composition differs")
    p.add_argument("--full_teacher", action="store_true",
                   help="run the teacher on the full mixed batch (reverts fast-step "
                        "pruning 1 only; implied by --reference_exact_step)")
    p.add_argument("--exact_jitter", action="store_true",
                   help="restore the jittered-box GridConv passes (teacher jitter pass, "
                        "student jitter on every scene), so that train-mode GridConv BN "
                        "sees the reference's box population (reverts fast-step prunings "
                        "2 and 3; implied by --reference_exact_step)")
    p.add_argument("--view_stats", action="store_true",
                   help="load real labels of unlabeled scans and report "
                        "pseudo-label quality metrics (diagnostics only)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_scenes", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
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
    if args.model == "groupfree":
        raise SystemExit("--model groupfree: the SSL step with a Group-Free-3D teacher is not "
                         "ported; cli/pretrain.py trains and evaluates the model")
    if args.fast_step and args.reference_exact_step:
        raise SystemExit("--fast_step and --reference_exact_step conflict")
    from ..data.loader import DataLoader, SSLBatcher
    from ..models.factory import build_votenet
    from ..parallel import distributed, make_global_mesh, replicate, shard_train_step
    from ..train import checkpoint
    from ..train.state import create_train_state
    from ..train.steps import make_eval_loss, make_ssl_step
    from . import common

    dev = common.driver_device(args)
    group = make_global_mesh()
    logger = common.driver_logger(args, group)
    loaders = []
    try:
        logger(str(args))
        common.log_device(dev, logger, group)
        common.log_precision(args, logger)
        # --batch_size is per device (JAX cli/train.py:157-164)
        bl, bu = [int(x) for x in args.batch_size.split(",")]
        w = group.world
        if w > 1:
            logger(f"data-parallel over {w} devices: per-device batch {bl}+{bu}, "
                   f"global {bl * w}+{bu * w}")

        labeled_ds, unlabeled_ds, eval_ds, cfg = common.build_ssl_datasets(args)
        logger(f"labeled {len(labeled_ds)} unlabeled {len(unlabeled_ds)} eval {len(eval_ds)}")
        # the loaders fork their workers before the model touches the card
        loaders.append(DataLoader(labeled_ds, bl, shuffle=True, num_workers=args.num_workers,
                                  seed=args.seed, rank=group.rank, world_size=w))
        loaders.append(DataLoader(unlabeled_ds, bu, shuffle=True,
                                  num_workers=args.num_workers, seed=args.seed + 1,
                                  rank=group.rank, world_size=w))
        if len(loaders[0]) == 0 or len(loaders[1]) == 0:
            raise SystemExit(
                f"batch sizes {bl * w}+{bu * w} exceed the dataset "
                f"({len(labeled_ds)} labeled / {len(unlabeled_ds)} unlabeled "
                "scenes): zero batches per epoch (drop_last) — shrink --batch_size")
        ssl_loader = SSLBatcher(loaders[0], loaders[1])
        if group.rank == 0:  # rank 0 evaluates the whole eval set, JAX's global batch
            loaders.append(DataLoader(eval_ds, (bl + bu) * w, shuffle=False, drop_last=False,
                                      num_workers=args.num_workers))

        model, _ = build_votenet(
            args.dataset, num_proposal=args.num_target,
            input_feature_dim=(0 if args.no_height else 1) + (3 if args.use_color else 0),
            sampling=args.cluster_sampling, tiny=args.tiny, vote_factor=args.vote_factor,
            device=dev, generator=torch.Generator().manual_seed(args.seed),
            **common.model_precision(args))
        state = create_train_state(model, seed=args.seed + 1, weight_decay=args.weight_decay,
                                   with_ema=True)

        start_epoch = 0
        # every rank reads the file; replicate below makes every rank hold rank 0's
        ckpt_path = os.path.join(args.log_dir, "checkpoint.tar")
        if args.resume and os.path.exists(ckpt_path):
            start_epoch, _ = checkpoint.load(ckpt_path, state)
            logger(f"resumed from {ckpt_path} at epoch {start_epoch}")
        elif args.detector_checkpoint:
            if args.eval and "ema_model_state_dict" in checkpoint.read(args.detector_checkpoint):
                # an SSL checkpoint to score: keep its teacher, so that
                # --eval_use_ema scores the saved EMA model (the reference's
                # own loader mirrors the student into the teacher,
                # train.py:216-218)
                checkpoint.load(args.detector_checkpoint, state)
            else:
                # stage-1 weights into the student and the teacher
                # (train.py:204-228)
                checkpoint.load_pretrain_into_ssl(args.detector_checkpoint, state)
            logger(f"loaded weights from {args.detector_checkpoint}")
        replicate(state, group)

        step = make_ssl_step(
            cfg, num_labeled=bl, unlabeled_weight=args.unlabeled_loss_weight,
            ema_decay=args.ema_decay, obj_threshold=args.obj_threshold,
            cls_threshold=args.cls_threshold, iou_threshold=args.iou_threshold,
            dataset=args.dataset, view_stats=args.view_stats,
            reference_exact=not args.fast_step,
            full_teacher=args.full_teacher, exact_jitter=args.exact_jitter)
        step = shard_train_step(step, group)
        eval_model = state.ema_model if args.eval_use_ema else state.model
        # random sampling's eval indices: a generator of their own, so that an
        # eval leaves the training draws (state.generator) where they were
        eval_loss = make_eval_loss(eval_model, cfg,
                                   generator=torch.Generator(device=dev).manual_seed(args.seed + 2))
        config_dict = common.make_config_dict(cfg, args)

        def eval_epoch(opt_rate=0.0, opt_step=0, dump=None):
            return common.evaluate(eval_model, cfg, common.staged(loaders[2], dev), config_dict,
                                   logger, eval_loss, (0.25, 0.5), opt_rate=opt_rate,
                                   opt_step=opt_step, dump_dir=dump)

        if args.eval:
            if group.rank != 0:
                return None
            return eval_epoch(args.opt_rate, args.opt_step,
                              os.path.join(args.log_dir, "dump") if args.dump_results else None)
        common.train_epochs(args, state, step, ssl_loader, eval_epoch, logger, ckpt_path,
                            start_epoch, dev, group)
        return None
    finally:
        for ld in loaders:
            ld.close()
        logger.close()
        distributed.shutdown()


if __name__ == "__main__":
    main()
