"""Shared-MLP building blocks, channels-last.

Counterpart of ``iou3dmatch_tpu/models/mlp.py`` (reference
``pointnet2/pytorch_utils.py:14-263``). A 1x1 convolution over points is a
matrix product on the last axis, so every layer is ``F.linear`` on
channels-last tensors; the weights keep the reference's convolution shapes,
so the state-dict keys and shapes are the reference 3DIoUMatch ones.

Initialisation draws from an explicit ``torch.Generator``:

- SharedMLP convolutions: ``kaiming_normal_`` (std sqrt(2 / fan_in)) and no
  bias, as the reference's BN-followed 1x1 convs (pytorch_utils.py:17).
- Head convolutions (voting, proposal and GridConv heads): PyTorch's default
  Conv1d init, weight and bias ~ U(+-1/sqrt(fan_in)).
"""
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Channels-last batch norm with torch's semantics, eps 1e-5.

    Train mode takes statistics over all leading axes, normalises with the
    biased batch variance and updates ``running = (1 - m) * running + m *
    batch`` with the unbiased variance, as the JAX ``BatchNorm``
    (``iou3dmatch_tpu/models/mlp.py:21-63``) and torch's BatchNorm2d do.
    ``m`` is ``self.momentum``, set per step by ``set_bn_momentum`` (the
    reference's BNMomentumScheduler); train mode refuses to run before it
    is set. The statistics are two-pass, where the JAX package uses one
    pass: PyTorch's native CUDA kernels (``F.batch_norm``) on the card, and
    on the CPU ``two_pass``, written out, since PyTorch's CPU kernel loses
    float32 precision on channels whose mean dwarfs their spread
    (``tests/torch_grad_precision.py``). The card keeps the native kernels
    for speed: ``chip_smoke.py`` times both forms at the pretrain step's
    shapes (PERF.md).

    Keys: ``weight``, ``bias``, ``running_mean``, ``running_var`` (no
    ``num_batches_tracked``: nothing reads it)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.momentum = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean) * inv * self.weight + self.bias
        if self.momentum is None:
            raise RuntimeError("train-mode BatchNorm needs a momentum: call set_bn_momentum")
        flat = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            out = F.batch_norm(flat, self.running_mean, self.running_var, self.weight, self.bias,
                               True, self.momentum, self.eps)
        else:
            out = self.two_pass(flat)
        return out.reshape(x.shape)

    def two_pass(self, flat: torch.Tensor) -> torch.Tensor:
        """Train mode on (rows, C) with the statistics written out: the mean,
        then the biased variance of the centred rows; updates the running
        statistics."""
        mean = flat.mean(0)
        centered = flat - mean
        var = (centered * centered).mean(0)
        with torch.no_grad():
            n, m = flat.shape[0], self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var * (n / max(n - 1, 1)))
        return centered * torch.rsqrt(var + self.eps) * self.weight + self.bias


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """Sets the running-statistics momentum of every BatchNorm in ``model``
    (``train/schedules.py::get_bn_momentum`` gives it per epoch)."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.momentum = float(momentum)


class PointwiseConv(nn.Module):
    """A 1x1 convolution applied to channels-last input. ``weight`` keeps the
    convolution's shape: (out, in, 1, 1) in a SharedMLP, (out, in, 1) in a
    head."""

    def __init__(self, weight: torch.Tensor, bias=None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


def shared_conv(cin: int, cout: int, generator: torch.Generator) -> PointwiseConv:
    """Bias-free (out, in, 1, 1) conv with kaiming-normal init."""
    w = torch.empty(cout, cin, 1, 1).normal_(0.0, (2.0 / cin) ** 0.5, generator=generator)
    return PointwiseConv(w)


def head_conv(cin: int, cout: int, generator: torch.Generator) -> PointwiseConv:
    """(out, in, 1) conv with bias and PyTorch's default Conv1d init."""
    bound = 1.0 / cin ** 0.5
    w = torch.empty(cout, cin, 1).uniform_(-bound, bound, generator=generator)
    b = torch.empty(cout).uniform_(-bound, bound, generator=generator)
    return PointwiseConv(w, b)


class _ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        self.conv = shared_conv(cin, cout, generator)
        self.bn = nn.ModuleDict({"bn": BatchNorm(cout)})  # reference key: layerK.bn.bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn["bn"](self.conv(x)))


class SharedMLP(nn.Sequential):
    """conv -> BN -> ReLU layers ``layer0``, ``layer1``, ... over the last
    axis; ``channels`` lists the input width and then each layer's width."""

    def __init__(self, channels, generator: torch.Generator):
        super().__init__(OrderedDict(
            (f"layer{i}", _ConvBNReLU(cin, cout, generator))
            for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:]))))
