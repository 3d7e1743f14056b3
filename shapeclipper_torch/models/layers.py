"""BottleneckLinear residual block and LatentProjection (counterpart of
`shapeclipper_tpu/models/layers.py`).

BatchNorm is plain `nn.BatchNorm1d` (the JAX package's `GroupBatchNorm` with
`groups=1`); the grouped, merged-encoder paths are not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(weight, generator=None):
    """Variance-1/fan_in normal init (flax Dense's default scale), drawn from
    `generator`; torch weights are [out, in]."""
    return nn.init.normal_(weight, 0.0, 1.0 / math.sqrt(weight.shape[1]),
                           generator=generator)


def batch_norm_1d(channels):
    # flax momentum 0.9 == torch momentum 0.1
    return nn.BatchNorm1d(channels, eps=1e-5, momentum=0.1)


class BottleneckLinear(nn.Module):
    """Two bias-free Dense layers on a [B, C] vector with BatchNorm and a
    residual (reference `Bottleneck_Linear`). `zero_init` zeroes bn2's scale
    (the estimator variant), so the block starts as relu(x)."""

    def __init__(self, n_channels, zero_init=False, generator=None):
        super().__init__()
        self.linear1 = nn.Linear(n_channels, n_channels, bias=False)
        self.bn1 = batch_norm_1d(n_channels)
        self.linear2 = nn.Linear(n_channels, n_channels, bias=False)
        self.bn2 = batch_norm_1d(n_channels)
        lecun_normal_(self.linear1.weight, generator)
        lecun_normal_(self.linear2.weight, generator)
        if zero_init:
            nn.init.zeros_(self.bn2.weight)

    def forward(self, x):
        out = torch.relu(self.bn1(self.linear1(x)))
        out = self.bn2(self.linear2(out))
        return torch.relu(out + x)


class LatentProjection(nn.Module):
    """2x BottleneckLinear + Dense -> low-dim conditioning code
    (reference `model/graph.py:56-65`)."""

    def __init__(self, n_channels, out_dim, generator=None):
        super().__init__()
        self.block0 = BottleneckLinear(n_channels, generator=generator)
        self.block1 = BottleneckLinear(n_channels, generator=generator)
        self.proj = nn.Linear(n_channels, out_dim)
        lecun_normal_(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        return self.proj(self.block1(self.block0(x)))
