"""Train state and optimizer.

Counterpart of ``iou3dmatch_tpu/train/state.py``. The JAX state holds
params, batch statistics and the Adam moments of the raveled parameter
vector; here the model holds its parameters and BN buffers, and
``torch.optim.Adam`` its moments, leaf by leaf (Adam is elementwise, so
the math is the same). The optimizer runs its ``foreach`` implementation:
a few multi-tensor kernels a step over all parameters.
"""
from dataclasses import dataclass

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
    the number of steps taken and the generator of the box-jitter noise,
    which lives on the model's device."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(model: nn.Module, seed: int = 0, weight_decay: float = 0.0,
                       adam_eps: float = 1e-8) -> TrainState:
    device = next(model.parameters()).device
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), weight_decay, adam_eps),
                      generator=torch.Generator(device=device).manual_seed(seed))
