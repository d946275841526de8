"""Pretrain step and eval forward.

Counterpart of ``iou3dmatch_tpu/train/steps.py``: ``make_pretrain_step``
(``:44-76``) and ``make_eval_forward`` (``:222-245``), whose outputs and
eval-loss metrics the port splits into ``make_eval_forward`` and
``make_eval_loss``.
"""
from typing import Optional, Tuple

import torch

from ..losses import get_labeled_loss, get_loss
from ..models.mlp import set_bn_momentum
from .state import TrainState

KEEP = (
    "center", "heading_scores", "heading_residuals", "size_scores",
    "size_residuals", "sem_cls_scores", "objectness_scores",
    "iou_scores", "size", "heading", "seed_xyz", "seed_features",
    "vote_xyz", "vote_features", "aggregated_vote_xyz",
)


def make_pretrain_step(cfg):
    """Returns ``step(state, batch, lr, bn_momentum, noise=None) ->
    metrics``, one supervised pretrain step (pretrain.py:310-347):
    ``forward_with_pred_jitter`` in train mode with BN momentum
    ``bn_momentum``, ``get_labeled_loss`` over every scene of the batch,
    the backward pass, then Adam at ``lr``. It updates ``state`` in place
    and returns the loss metrics, ``loss`` included, as detached tensors
    on the model's device, without waiting for the card. ``noise``
    optionally gives the two jitter draws; else they come from
    ``state.generator``."""

    def step(state: TrainState, batch: dict, lr: float, bn_momentum: float,
             noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> dict:
        model, opt = state.model, state.optimizer
        model.train()
        set_bn_momentum(model, bn_momentum)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        point_clouds = batch["point_clouds"]
        ep = model.forward_with_pred_jitter(point_clouds, generator=state.generator, noise=noise)
        loss, metrics = get_labeled_loss(ep, batch, cfg, point_clouds.shape[0])
        loss.backward()
        opt.step()
        state.step += 1
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_forward(model):
    """Returns ``forward(point_clouds) -> dict`` of the outputs the host-side
    AP pipeline reads. It runs ``model`` in eval mode under
    ``torch.inference_mode()``; the outputs stay on the model's device."""

    def forward(point_clouds: torch.Tensor) -> dict:
        model.eval()
        with torch.inference_mode():
            ep = model(point_clouds)
        return {k: ep[k] for k in KEEP if k in ep}

    return forward


def make_eval_loss(model, cfg):
    """Returns ``evaluate(point_clouds, labels) -> (outputs, metrics)``, the
    JAX ``make_eval_forward``: one eval-mode forward under
    ``torch.inference_mode()``, the outputs ``make_eval_forward`` keeps, and
    the eval-loss metrics of ``losses/supervised.py::get_loss`` on the GT
    dict ``labels``, ``loss`` among them."""

    def evaluate(point_clouds: torch.Tensor, labels: dict):
        model.eval()
        with torch.inference_mode():
            ep = model(point_clouds)
            loss, metrics = get_loss(ep, labels, cfg)
        metrics["loss"] = loss
        return {k: ep[k] for k in KEEP if k in ep}, metrics

    return evaluate
