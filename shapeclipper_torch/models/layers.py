"""BottleneckLinear residual block and LatentProjection (counterpart of
`shapeclipper_tpu/models/layers.py`).

`BatchNorm` is the JAX package's `GroupBatchNorm` as `Graph._apply_bn` uses
it: view groups (`bn_groups`: one ResNet call over the query and its
neighbour views, each group normalised with its own moments and the running
statistics composed as sequential calls would), the per-replica split of
`tpu.bn_mode: per_replica` (`replicas` contiguous blocks a group, the
running statistics from each group's block 0), and under data parallelism
the global-batch moments summed over the ranks (`sync`). A bfloat16 input
(the ResNets at `tpu.encoder_dtype: bfloat16`) is normalised in float32,
moments and sums included, and the result is cast back to bfloat16, as
`GroupBatchNorm(dtype=bfloat16)` does.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from .. import parallel


def widen(x):
    """A half-precision tensor as float32; any other as it is."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def lecun_normal_(weight, generator=None):
    """Variance-1/fan_in normal init (flax Dense's default scale), drawn from
    `generator`; torch weights are [out, in]."""
    return nn.init.normal_(weight, 0.0, 1.0 / math.sqrt(weight.shape[1]),
                           generator=generator)


class BatchNorm(_BatchNorm):
    """BatchNorm over [B, C] or [B, C, H, W] with `GroupBatchNorm`'s
    semantics, under torch's state_dict names (weight, bias, running_mean,
    running_var, num_batches_tracked).

    * eval mode: the running statistics, exactly as `nn.BatchNorm*d`;
    * train mode: the biased batch variance normalises, and the running
      statistics take `0.9 * running + 0.1 * batch` with the BIASED batch
      variance (`nn.BatchNorm*d` would use the unbiased one, n/(n-1) larger);
    * `groups = G` (train mode, set by `bn_groups`): a [G * B, ...] batch
      of G view groups, each normalised with its own moments; the running
      statistics take the update of each group in `stats_groups` in turn
      (None: every group in order; (): none), as G sequential calls whose
      listed ones update, and `num_batches_tracked` counts one a listed
      group;
    * `replicas = n` (train mode): each group splits into n contiguous
      blocks, each normalised with its own moments, and the running
      statistics follow each listed group's block 0 only (JAX's
      per-replica BN, DDP's per-GPU BN with rank 0's buffers broadcast);
    * `sync` (train mode): Σx, Σx² and the count, per group, are summed
      over the ranks with autograd, so every rank normalises with the global
      batch's moments (JAX's global BN across the data mesh; not
      `nn.SyncBatchNorm`, whose running variance is the unbiased one);
    * train mode inside `batch_stats_frozen`: batch statistics, no update
      (the flipped cam_sym estimator pass, whose update JAX discards);
    * every mode: a bfloat16 input normalised in float32, the output in
      the input's dtype.
    """

    def __init__(self, channels):
        # flax momentum 0.9 == torch momentum 0.1
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.update_stats = True
        self.replicas = 1
        self.sync = False
        self.groups = 1
        self.stats_groups = None

    def _check_input_dim(self, x):
        if x.dim() not in (2, 4):
            raise ValueError(f"expected a 2-D or 4-D input, got {x.dim()}-D")

    def forward(self, x):
        self._check_input_dim(x)
        dtype = x.dtype
        x = widen(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(dtype)
        # GroupBatchNorm's arithmetic, so that train mode (forward and
        # gradient) follows the JAX package also where var << mean^2
        G, n = self.groups, self.replicas
        blocks = G * n
        if blocks == 1:
            xs, dims = x, [0] + list(range(2, x.dim()))
            shape = [1, -1] + [1] * (x.dim() - 2)
        else:   # [G * n, B / n, C, ...]: one set of moments per block
            xs = x.reshape(blocks, x.shape[0] // blocks, *x.shape[1:])
            dims = [1] + list(range(3, xs.dim()))
            shape = [blocks, 1, -1] + [1] * (x.dim() - 2)
        # Σx, Σx² over a count on the device in every mode, so that one
        # rank under a process group computes exactly what no group does
        s1, s2 = xs.sum(dim=dims), (xs * xs).sum(dim=dims)
        count = s1.new_full((1,), x.numel() / (blocks * x.shape[1]))
        if self.sync:
            assert n == 1, "per-replica moments are never summed over ranks"
            k = s1.numel()
            sums = parallel.all_reduce_sum(
                torch.cat([s1.reshape(-1), s2.reshape(-1), count]))
            s1 = sums[:k].reshape(s1.shape)
            s2, count = sums[k:2 * k].reshape(s2.shape), sums[-1:]
        mean, mean2 = s1 / count, s2 / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if self.update_stats:
            listed = (range(G) if self.stats_groups is None
                      else self.stats_groups)
            with torch.no_grad():
                for g in listed:   # each listed group's block 0, in turn
                    self.running_mean.lerp_(
                        mean if blocks == 1 else mean[g * n], self.momentum)
                    self.running_var.lerp_(
                        var if blocks == 1 else var[g * n], self.momentum)
                self.num_batches_tracked += len(listed)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xs - mean.reshape(shape)) * mul.reshape(shape)
             + self.bias.view([1, -1] + [1] * (x.dim() - 2)))
        return y.reshape(x.shape).to(dtype)


def set_bn_mode(module, replicas=1, sync=False):
    """Every BatchNorm under `module` takes `replicas` blocks and, with
    `sync`, the moments summed over the ranks."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.replicas, m.sync = int(replicas), bool(sync)


@contextlib.contextmanager
def batch_stats_frozen(module):
    """Train-mode BatchNorms under `module` normalise with their batch
    statistics but leave the running statistics as they are."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


@contextlib.contextmanager
def bn_groups(module, groups, stats_groups=None):
    """Train-mode BatchNorms under `module` take a [groups * B, ...] batch of
    view groups, each normalised with its own moments, and update the
    running statistics from the groups `stats_groups` in order (None: all;
    see `BatchNorm`); back to one group after the block."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    listed = None if stats_groups is None else tuple(stats_groups)
    for m in bns:
        m.groups, m.stats_groups = int(groups), listed
    try:
        yield
    finally:
        for m in bns:
            m.groups, m.stats_groups = 1, None


class BottleneckLinear(nn.Module):
    """Two bias-free Dense layers on a [B, C] vector with BatchNorm and a
    residual (reference `Bottleneck_Linear`). `zero_init` zeroes bn2's scale
    (the estimator variant), so the block starts as relu(x)."""

    def __init__(self, n_channels, zero_init=False, generator=None):
        super().__init__()
        self.linear1 = nn.Linear(n_channels, n_channels, bias=False)
        self.bn1 = BatchNorm(n_channels)
        self.linear2 = nn.Linear(n_channels, n_channels, bias=False)
        self.bn2 = BatchNorm(n_channels)
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
