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
    """Channels-last batch norm with torch's eval semantics, eps 1e-5.

    Keys: ``weight``, ``bias``, ``running_mean``, ``running_var`` (no
    ``num_batches_tracked``: nothing reads it)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "batch statistics come with the training slice; call .eval()")
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias


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
