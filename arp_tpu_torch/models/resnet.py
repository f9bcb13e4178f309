"""ResNet v1 and the DenseResnet value network (port of arp_tpu/models/resnet.py).

Inputs are (batch, h, w, c) as in the Flax modules; the convolutions run channels-first
inside.  Submodules carry Flax's names (``conv_init``, ``bn_init``, ``ResNetBlock_3``,
``Conv_0``, ``BatchNorm_1``, ``conv_proj``, ``norm_proj``, ``Dense_0``, ``block1``), so
``params`` and ``batch_stats`` cross by models/clip/convert.py::flax_to_torch and back by
``torch_to_flax`` (BatchNorm ``scale`` -> ``weight``, ``mean`` / ``var`` -> the
``running_mean`` / ``running_var`` buffers).  As in Flax:

  * a ``"SAME"`` convolution or max pool pads ``total // 2`` before and the rest after:
    (0, 1) at stride 2 on an even side, not torch's symmetric 1;
  * BatchNorm (momentum 0.9, eps 1e-5) normalizes with the batch's statistics in train
    mode, the variance ``E[x^2] - E[x]^2`` (biased, clipped at 0), and updates
    ``running = 0.9 running + 0.1 batch`` in place; in eval mode it uses the running
    statistics.  torch's own BatchNorm would update with the unbiased variance;
  * the last BatchNorm of a block starts with a zero scale;
  * the head averages over h and w, then a float32 Dense.

ResNet's input channels are an argument (``in_channels``, 3 by default); DenseResnet's
``Dense_0`` takes its input width at the first call, as Flax's does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(x: torch.Tensor, kernel: int, stride: int) -> list:
    """F.pad's list for XLA's SAME padding of the last two dims of ``x``."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return pads


class Conv(nn.Conv2d):
    """Flax ``nn.Conv(features, (k, k), (s, s), use_bias=False)``: SAME padding, or ``padding`` on
    every side where it is given."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1, padding=None):
        super().__init__(in_ch, features, kernel, stride, bias=False)
        self.pad = padding

    def forward(self, x):
        pads = _same_pads(x, self.kernel_size[0], self.stride[0]) if self.pad is None else [self.pad] * 4
        return F.conv2d(F.pad(x, pads), self.weight, stride=self.stride)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of (B, C, H, W)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.zeros(features) if zero_scale else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = False):
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean.detach())
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, act: Callable = F.relu, strides: int = 1):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_ch, filters, 3, strides)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        if in_ch != filters or strides != 1:
            self.conv_proj = Conv(in_ch, filters, 1, strides)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x, train: bool = False):
        y = self.act(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x), train)
        return self.act(x + y)


class BottleneckResNetBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, act: Callable = F.relu, strides: int = 1):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_ch, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True)
        if in_ch != filters * 4 or strides != 1:
            self.conv_proj = Conv(in_ch, filters * 4, 1, strides)
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x, train: bool = False):
        y = self.act(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.act(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x), train)
        return self.act(x + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls, num_outputs: int, num_filters: int = 64,
                 act: Callable = F.relu, in_channels: int = 3):
        super().__init__()
        self.act, self.num_blocks = act, sum(stage_sizes)
        self.conv_init = Conv(in_channels, num_filters, 7, 2, padding=3)
        self.bn_init = BatchNorm(num_filters)
        in_ch, k = num_filters, 0
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                filters = num_filters * 2 ** i
                self.add_module(f"{block_cls.__name__}_{k}",
                                block_cls(in_ch, filters, act, strides=2 if i > 0 and j == 0 else 1))
                in_ch, k = filters * block_cls.expansion, k + 1
        self.block_name = block_cls.__name__
        self.Dense_0 = nn.Linear(in_ch, num_outputs)

    def forward(self, x, train: bool = False):
        """(B, H, W, C) -> (B, num_outputs); ``train`` normalizes with the batch's statistics and
        updates the running ones in place (Flax's ``mutable=["batch_stats"]``)."""
        x = self.act(self.bn_init(self.conv_init(x.permute(0, 3, 1, 2)), train))
        x = F.max_pool2d(F.pad(x, _same_pads(x, 3, 2), value=float("-inf")), 3, 2)
        for k in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{k}")(x, train)
        return self.Dense_0(x.float().mean(dim=(2, 3)))


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckResNetBlock)


class DenseResnetBlock(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.Dense_1 = nn.Linear(features, features)
        if in_features != features:
            self.proj = nn.Linear(in_features, features)

    def forward(self, x):
        y = self.Dense_1(F.relu(self.Dense_0(x)))
        if hasattr(self, "proj"):
            x = self.proj(x)
        return F.relu(x + y)


class DenseResnet(nn.Module):
    """MLP with residual blocks (value-network style): ``Dense_0``, ``block{i}``, ``Dense_1``."""

    def __init__(self, features: int = 256, num_blocks: int = 2, num_outputs: int = 1):
        super().__init__()
        self.num_blocks = num_blocks
        self.Dense_0 = nn.LazyLinear(features)
        for i in range(num_blocks):
            self.add_module(f"block{i}", DenseResnetBlock(features, features))
        self.Dense_1 = nn.Linear(features, num_outputs)

    def forward(self, x):
        x = F.relu(self.Dense_0(x))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.Dense_1(x)
