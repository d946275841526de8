"""Pretrain step, SSL step and eval forward.

Counterpart of ``iou3dmatch_tpu/train/steps.py``: ``ema_update``
(``:25-28``), ``make_pretrain_step`` (``:44-76``), ``make_ssl_step``
(``:79-215``) and ``make_eval_forward`` (``:222-245``), whose outputs and
eval-loss metrics the port splits into ``make_eval_forward`` and
``make_eval_loss``.

A step is the span ``train.step`` of ``utils/trace.py``, which counts the
host syncs inside it; its phases are the spans ``train.teacher``,
``train.student``, ``train.loss``, ``train.backward`` and ``train.update``
(the optimizer and the EMA). The eval loss is ``eval.forward``.
"""
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..losses import get_labeled_loss, get_loss, get_unlabeled_loss
from ..models.mlp import set_bn_momentum
from ..ops import furthest_point_sample
from ..parallel.collectives import all_reduce_grads, current
from ..parallel.mesh import take_rows
from ..utils import trace
from .state import TrainState

KEEP = (
    "center", "heading_scores", "heading_residuals", "size_scores",
    "size_residuals", "sem_cls_scores", "objectness_scores",
    "iou_scores", "size", "heading", "seed_xyz", "seed_features",
    "vote_xyz", "vote_features", "aggregated_vote_xyz",
)


def _global_draws(model, generator, num_labeled: int, num_unlabeled: int, noise=None,
                  jitter: bool = True):
    """Under a data group: one forward's random tensors drawn at the global
    batch's shapes from ``generator``, in the forward's order (``random``
    sampling's proposal indices, then the two jitter draws unless ``noise``,
    global, gives them or ``jitter`` is off), and this rank's rows
    ``[L_r; U_r]`` of them, for a rank holding ``num_labeled`` +
    ``num_unlabeled`` rows. Every rank draws the same numbers, so the
    generators stay in step, and a single process on the global batch draws
    them too. Returns (sample_inds or None, noise or None)."""
    group = current()
    w, dev = group.world, generator.device
    b, k = (num_labeled + num_unlabeled) * w, model.pnet.num_proposal

    def rows(x):
        return take_rows(x, group.rank, w, num_labeled * w, num_unlabeled * w)

    inds = None
    if model.pnet.sampling == "random":
        num_seed = model.backbone_net.sa2.npoint
        inds = rows(torch.randint(0, num_seed, (b, k), generator=generator, device=dev,
                                  dtype=torch.int32))
    if jitter and noise is None:
        noise = tuple(torch.randn((b, k, 3), generator=generator, device=dev) for _ in range(2))
    if noise is not None:
        noise = tuple(rows(n) for n in noise)
    return inds, noise


def make_pretrain_step(cfg, loss=None):
    """Returns ``step(state, batch, lr, bn_momentum, noise=None) ->
    metrics``, one supervised pretrain step (pretrain.py:310-347):
    ``forward_with_pred_jitter`` in train mode with BN momentum
    ``bn_momentum``, the model's ``loss(ep, batch, cfg, num_labeled) ->
    (loss, metrics)`` over every scene of the batch (VoteNet's
    ``get_labeled_loss`` by default), the backward pass, then the
    optimizer at ``lr``, times the ``lr_scale`` of a parameter group that
    has one (``train/state.py``). It updates ``state`` in place
    and returns the loss metrics, ``loss`` included, as detached tensors
    on the model's device, without waiting for the card. ``noise``
    optionally gives the two jitter draws; else they come from
    ``state.generator``, after the proposal indices of ``random``
    sampling. Under ``parallel/mesh.py::shard_train_step`` the draws and
    ``noise`` have the global batch's shape, this rank takes its rows, and
    the gradient is summed over the ranks before Adam."""
    loss_fn = get_labeled_loss if loss is None else loss

    @trace.span("train.step", sync_count=True)
    def step(state: TrainState, batch: dict, lr: float, bn_momentum: float,
             noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> dict:
        model, opt = state.model, state.optimizer
        model.train()
        set_bn_momentum(model, bn_momentum)
        for group in opt.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        opt.zero_grad(set_to_none=True)
        point_clouds = batch["point_clouds"]
        inds = None
        if current() is not None:
            inds, noise = _global_draws(model, state.generator, point_clouds.shape[0], 0, noise)
        with trace.span("train.student"):
            ep = model.forward_with_pred_jitter(point_clouds, generator=state.generator,
                                                noise=noise, sample_inds=inds)
        with trace.span("train.loss"):
            total, metrics = loss_fn(ep, batch, cfg, point_clouds.shape[0])
        with trace.span("train.backward"):
            total.backward()
        with trace.span("train.update"):
            all_reduce_grads(model.parameters())
            opt.step()
        state.step += 1
        metrics["loss"] = total
        return {k: v.detach() for k, v in metrics.items()}

    return step


def ema_update(ema_model: nn.Module, model: nn.Module, alpha: float) -> None:
    """ema = alpha * ema + (1 - alpha) * param over ``parameters()``, BN
    affine weights included, in place (train.py:285-289); BN running
    statistics are not averaged. ``alpha`` and 1 - alpha are rounded to
    f32, and the two products are rounded before their sum, as in JAX."""
    alpha = np.float32(alpha)
    ema = [p.detach() for p in ema_model.parameters()]
    torch._foreach_mul_(ema, float(alpha))
    torch._foreach_add_(ema, torch._foreach_mul([p.detach() for p in model.parameters()],
                                                float(np.float32(1.0) - alpha)))


def make_ssl_step(cfg, num_labeled: int, *, unlabeled_weight: float = 2.0,
                  ema_decay: float = 0.999, obj_threshold: float = 0.9,
                  cls_threshold: float = 0.9, iou_threshold: float = 0.25,
                  nms_iou: float = 0.25, use_lhs: bool = True, samecls_match: bool = False,
                  dataset: str = "scannet", view_stats: bool = False,
                  reference_exact: bool = False, full_teacher: bool = False,
                  exact_jitter: bool = False):
    """Returns ``step(state, batch, lr, bn_momentum, noise=None) ->
    metrics``, one mean-teacher SSL step (train.py:305-371) on a batch of
    ``num_labeled`` labeled scenes followed by unlabeled ones. ``state``
    needs the teacher (``create_train_state(..., with_ema=True)``). In
    order:

    1. one SA1 FPS over the teacher's and the student's clouds together;
    2. the teacher, in train mode without gradient, on
       ``batch["ema_point_clouds"]`` (BN momentum ``bn_momentum``, its own
       running statistics updated);
    3. the student's ``forward_with_pred_jitter`` on
       ``batch["point_clouds"]``;
    4. ``get_labeled_loss + unlabeled_weight * get_unlabeled_loss``;
    5. the backward pass and Adam at ``lr``;
    6. the EMA of the parameters into the teacher with alpha =
       min(1 - 1/(step + 2), ema_decay), the code's rule (steps.py:200-206;
       its docstring says step + 1).

    The knobs are the JAX step's. By default the teacher sees only the
    unlabeled scenes and runs the plain forward, and the student jitters
    only the labeled scenes: outputs the reference computes and then
    discards. ``full_teacher`` runs the teacher on every scene;
    ``exact_jitter`` gives the teacher the jittered forward and the student
    jittered copies of every scene; ``reference_exact`` implies both.

    ``noise`` optionally gives the jitter draws as (teacher, student), each
    the two (B, K, 3) standard-normal tensors of
    ``forward_with_pred_jitter``, the teacher's unused without jittered
    teacher forward; else they come from ``state.generator``. The step
    draws from ``state.generator`` in this order: the teacher's proposal
    indices (``random`` sampling only), the teacher's jitter (jittered
    teacher forward only), the student's indices, the student's jitter;
    a resume restores the generator, so it continues the sequence. Under
    ``parallel/mesh.py::shard_train_step`` it draws them at the global
    batch's shapes (``noise`` has them too) and takes this rank's rows, and
    sums the gradient over the ranks before Adam. The step
    updates ``state`` in place and returns the loss metrics, ``loss``
    included, as detached tensors on the model's device, without waiting
    for the card."""
    teacher_full = reference_exact or full_teacher
    jitter_full = reference_exact or exact_jitter
    nl = num_labeled
    loss_args = dict(obj_threshold=obj_threshold, cls_threshold=cls_threshold,
                     iou_threshold=iou_threshold, nms_iou=nms_iou, use_lhs=use_lhs,
                     samecls_match=samecls_match, dataset=dataset, view_stats=view_stats,
                     ema_rows_are_unlabeled=not teacher_full)

    @trace.span("train.step", sync_count=True)
    def step(state: TrainState, batch: dict, lr: float, bn_momentum: float,
             noise: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor],
                                   Tuple[torch.Tensor, torch.Tensor]]] = None) -> dict:
        model, teacher, opt = state.model, state.ema_model, state.optimizer
        if teacher is None:
            raise ValueError("the SSL step needs a teacher: create_train_state(..., with_ema=True)")
        t_noise, s_noise = (None, None) if noise is None else noise
        for m in (model, teacher):
            m.train()
            set_bn_momentum(m, bn_momentum)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)

        # one FPS over the teacher's and the student's clouds: a launch of
        # 2B scenes costs little more than one of B (PERF.md)
        ema_clouds = batch["ema_point_clouds"]
        if not teacher_full:
            ema_clouds = ema_clouds[nl:]
        point_clouds = batch["point_clouds"]
        xyz = torch.cat([ema_clouds[..., 0:3], point_clouds[..., 0:3]], 0).contiguous()
        inds = furthest_point_sample(xyz, model.backbone_net.sa1.npoint)
        t_inds, s_inds = inds[:ema_clouds.shape[0]], inds[ema_clouds.shape[0]:]

        t_sample = s_sample = None
        if current() is not None:
            nu = point_clouds.shape[0] - nl
            t_sample, t_noise = _global_draws(teacher, state.generator, nl if teacher_full else 0,
                                              nu, t_noise, jitter=jitter_full)
            s_sample, s_noise = _global_draws(model, state.generator, nl, nu, s_noise)
        with trace.span("train.teacher"), torch.no_grad():
            if jitter_full:
                ema_ep = teacher.forward_with_pred_jitter(
                    ema_clouds, generator=state.generator, noise=t_noise, sa1_inds=t_inds,
                    sample_inds=t_sample)
            else:
                ema_ep = teacher(ema_clouds, sa1_inds=t_inds, generator=state.generator,
                                 sample_inds=t_sample)
        with trace.span("train.student"):
            ep = model.forward_with_pred_jitter(point_clouds, generator=state.generator,
                                                noise=s_noise, sa1_inds=s_inds,
                                                jitter_rows=None if jitter_full else nl,
                                                sample_inds=s_sample)
        with trace.span("train.loss"):
            sup_loss, metrics = get_labeled_loss(ep, batch, cfg, nl)
            unsup_loss, m2 = get_unlabeled_loss(ep, ema_ep, batch, cfg, nl, **loss_args)
            loss = sup_loss + unlabeled_weight * unsup_loss
        with trace.span("train.backward"):
            loss.backward()
        # the reference counts the step before the EMA (train.py:353-354)
        alpha = min(np.float32(1.0) - np.float32(1.0) / (np.float32(state.step) + np.float32(2.0)),
                    np.float32(ema_decay))
        with trace.span("train.update"):
            all_reduce_grads(model.parameters())
            opt.step()
            ema_update(teacher, model, alpha)
        state.step += 1
        metrics.update(m2)
        metrics["supervised_loss"] = sup_loss
        metrics["unsupervised_loss"] = unsup_loss
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_forward(model, generator: Optional[torch.Generator] = None):
    """Returns ``forward(point_clouds) -> dict`` of the outputs the host-side
    AP pipeline reads. It runs ``model`` in eval mode under
    ``torch.inference_mode()``; the outputs stay on the model's device.
    ``generator`` draws ``random`` sampling's proposal indices."""

    def forward(point_clouds: torch.Tensor) -> dict:
        model.eval()
        with torch.inference_mode():
            ep = model(point_clouds, generator=generator)
        return {k: ep[k] for k in KEEP if k in ep}

    return forward


def make_eval_loss(model, cfg, generator: Optional[torch.Generator] = None, loss=None):
    """Returns ``evaluate(point_clouds, labels) -> (outputs, metrics)``, the
    JAX ``make_eval_forward``: one eval-mode forward under
    ``torch.no_grad()``, the outputs ``make_eval_forward`` keeps, and the
    eval-loss metrics of ``loss(ep, labels, cfg)`` (by default
    ``losses/supervised.py::get_loss``) on the GT dict ``labels``, ``loss``
    among them. Not ``inference_mode``: test-time IoU
    optimisation (``eval/iou_opt.py``) differentiates through GridConv on
    these outputs, and autograd refuses to save inference tensors.
    ``generator`` draws ``random`` sampling's proposal indices."""
    loss_fn = get_loss if loss is None else loss

    @trace.span("eval.forward", device=True, sync_count=True)
    def evaluate(point_clouds: torch.Tensor, labels: dict):
        model.eval()
        with torch.no_grad():
            ep = model(point_clouds, generator=generator)
            total, metrics = loss_fn(ep, labels, cfg)
        metrics["loss"] = total
        return {k: ep[k] for k in KEEP if k in ep}, metrics

    return evaluate
