"""Viewpoint estimator: ResNet-18 backbone + trig extrinsic & scale heads
(counterpart of `shapeclipper_tpu/models/estimator.py`).

Extrinsics are three L2-normalized (cos, sin) pairs (azim / elev / theta),
plus tanh-bounded size and perspective scales. The init forces elev = theta
= 0 and scales = 1 (reference `model/view_estimator.py:58-70`). The
backbone computes in `dtype` (`tpu.encoder_dtype`); the heads in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from .layers import BottleneckLinear
from .resnet import resnet18


class EstimatorOutputs(NamedTuple):
    trig_azim: torch.Tensor    # [B, 2] (cos, sin)
    trig_elev: torch.Tensor    # [B, 2]
    trig_theta: torch.Tensor   # [B, 2]
    scale_focal: torch.Tensor  # [B]
    scale_dist: torch.Tensor   # [B]


def _normalize(x, eps=1e-12):
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


class Estimator(nn.Module):
    def __init__(self, size_range=0.2, perspect_range=0.0, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.size_range = size_range
        self.perspect_range = perspect_range
        n = 512  # resnet18 feature width
        self.feature_extractor = resnet18(num_classes=None,
                                          generator=generator, dtype=dtype)
        self.extr_head = BottleneckLinear(n, zero_init=True,
                                          generator=generator)
        self.extr_fc = nn.Linear(n, 6)
        self.size_head = BottleneckLinear(n, zero_init=True,
                                          generator=generator)
        self.size_fc = nn.Linear(n, 1)
        self.perspect_head = BottleneckLinear(n, zero_init=True,
                                              generator=generator)
        self.perspect_fc = nn.Linear(n, 1)
        with torch.no_grad():
            bound = 1.0 / math.sqrt(n)
            nn.init.uniform_(self.extr_fc.weight, -bound, bound,
                             generator=generator)
            self.extr_fc.weight[2:] = 0.0     # elev, theta start at angle 0
            self.extr_fc.bias.copy_(torch.tensor([0.0, 0.0, 1.0, 0.0, 1.0,
                                                  0.0]))
            for fc in (self.size_fc, self.perspect_fc):
                fc.weight.zero_()
                fc.bias.zero_()

    @staticmethod
    def from_opt(opt, generator=None, dtype=torch.float32):
        return Estimator(size_range=opt.camera.size_range,
                         perspect_range=opt.camera.perspect_range,
                         generator=generator, dtype=dtype)

    def heads(self, feat):
        """Trig extrinsic + scale heads on backbone features [B, 512]."""
        trig = self.extr_fc(self.extr_head(feat))
        scale_size_raw = torch.tanh(self.size_fc(self.size_head(feat)))
        scale_persp_raw = torch.tanh(
            self.perspect_fc(self.perspect_head(feat)))
        scale_size = 1.0 + scale_size_raw[..., 0] * self.size_range
        scale_perspect = 1.0 + scale_persp_raw[..., 0] * self.perspect_range
        return EstimatorOutputs(
            trig_azim=_normalize(trig[:, 0:2]),
            trig_elev=_normalize(trig[:, 2:4]),
            trig_theta=_normalize(trig[:, 4:6]),
            scale_focal=scale_perspect,
            scale_dist=scale_size * scale_perspect)

    def forward(self, images):
        """images [B, H, W, 3] -> EstimatorOutputs."""
        return self.heads(self.feature_extractor(images))


@torch.no_grad()
def reset_scale_params(estimator):
    """Zero the size / perspective fc heads in place, so the scales start at
    exactly 1 (reference `model/view_estimator.py:72-77`)."""
    for fc in (estimator.size_fc, estimator.perspect_fc):
        fc.weight.zero_()
        fc.bias.zero_()
