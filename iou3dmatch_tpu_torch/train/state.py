"""Train state and optimizer.

Counterpart of ``iou3dmatch_tpu/train/state.py``. The JAX state holds
params, batch statistics and the Adam moments of the raveled parameter
vector; here the model holds its parameters and BN buffers, and
``torch.optim.Adam`` its moments, leaf by leaf (Adam is elementwise, so
the math is the same). The optimizer runs its ``foreach`` implementation:
a few multi-tensor kernels a step over all parameters. For the SSL stage
the state also holds the teacher, ``ema_model``: the JAX ``ema_params``
and ``ema_batch_stats`` as a module of their own.

A model that names its own parameter groups (``optimizer_groups()``,
Group-Free-3D's) trains with AdamW over them, as its release does: the
weight decay decoupled, each group's lr the step's times its ``lr_scale``
(``train/steps.py``).
"""
import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn


def make_optimizer(params, weight_decay: float = 0.0, eps: float = 1e-8) -> torch.optim.Adam:
    """Adam, betas (0.9, 0.999); the lr is set by the step. Its update is
    optax's ``add_decayed_weights(weight_decay)`` followed by
    ``scale_by_adam(eps=eps)``: the decay is added to the gradient before
    the moments, and eps is added to sqrt(v_hat). ``eps`` is torch's
    default 1e-8 (pretrain.py:186); trajectory tests raise it."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=eps,
                            weight_decay=weight_decay, foreach=True)


@dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer,
    the number of steps taken, the generator of the box-jitter noise,
    which lives on the model's device, and for the SSL stage the teacher
    ``ema_model``: its parameters are the EMA of the model's, BN affine
    weights included, and its BN running statistics its own."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    ema_model: Optional[nn.Module] = None


def create_train_state(model: nn.Module, seed: int = 0, weight_decay: float = 0.0,
                       adam_eps: float = 1e-8, with_ema: bool = False) -> TrainState:
    """With ``with_ema`` the teacher starts as a deep copy of ``model``:
    a separate module, outside the optimizer, whose parameters take no
    gradient."""
    device = next(model.parameters()).device
    ema_model = None
    if with_ema:
        ema_model = copy.deepcopy(model).requires_grad_(False)
    if hasattr(model, "optimizer_groups"):
        optimizer = torch.optim.AdamW(model.optimizer_groups(), lr=0.0, betas=(0.9, 0.999),
                                      eps=adam_eps, weight_decay=weight_decay, foreach=True)
    else:
        optimizer = make_optimizer(model.parameters(), weight_decay, adam_eps)
    return TrainState(model=model, optimizer=optimizer,
                      generator=torch.Generator(device=device).manual_seed(seed),
                      ema_model=ema_model)
