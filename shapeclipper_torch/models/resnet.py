"""BasicBlock ResNet-18/34 written by hand (counterpart of
`shapeclipper_tpu/models/resnet.py`; torchvision is not a dependency).

Parameter names are torchvision's (`conv1`, `bn1`, `layer{i}.{j}.conv1`,
`layer{i}.{j}.downsample.{0,1}`, `fc`), so converted ImageNet state_dicts
(`scripts/convert_weights.py`) load as they are. The public layout is the JAX
package's NHWC: images enter as [B, H, W, 3] and are permuted to NCHW here.

`dtype` is the compute dtype, as flax's (`tpu.encoder_dtype`): the image is
cast to it, the convolutions run in it with their float32 weights cast at
use, BatchNorm normalises in float32 and returns it, and the pooled
features are cast to float32 before `fc`. Parameters and statistics stay
float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm, lecun_normal_, widen


class Conv2d(nn.Conv2d):
    """A bias-free convolution in its input's dtype: the float32 weight is
    cast at use."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def _conv(in_ch, out_ch, k, stride, padding, generator):
    conv = Conv2d(in_ch, out_ch, k, stride=stride, padding=padding,
                  bias=False)
    # flax variance_scaling(2.0, "fan_out", "normal")
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu",
                            generator=generator)
    return conv


def _bn(ch):
    return BatchNorm(ch)


class BasicBlock(nn.Module):
    def __init__(self, in_ch, filters, stride=1, generator=None):
        super().__init__()
        self.conv1 = _conv(in_ch, filters, 3, stride, 1, generator)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, 1, 1, generator)
        self.bn2 = _bn(filters)
        self.downsample = None
        if in_ch != filters or stride != 1:
            self.downsample = nn.Sequential(
                _conv(in_ch, filters, 1, stride, 0, generator), _bn(filters))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """BasicBlock ResNet on NHWC images in [0, 1], computed in `dtype`.
    `num_classes=None` returns the pooled 512-d features (float32)."""

    def __init__(self, stage_sizes, num_classes=1000, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, generator)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for i, count in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            blocks = []
            for j in range(count):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(BasicBlock(in_ch, filters, stride, generator))
                in_ch = filters
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = None
        if num_classes is not None:
            self.fc = nn.Linear(in_ch, num_classes)
            lecun_normal_(self.fc.weight, generator)
            nn.init.zeros_(self.fc.bias)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous()             # NHWC -> NCHW
        if self.dtype != torch.float32:   # float32 keeps the input's dtype
            x = x.to(self.dtype)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        x = widen(x.mean(dim=(2, 3)))                       # [B, 512]
        return x if self.fc is None else self.fc(x)


def resnet18(num_classes=None, generator=None, dtype=torch.float32):
    return ResNet((2, 2, 2, 2), num_classes=num_classes, generator=generator,
                  dtype=dtype)


def resnet34(num_classes=None, generator=None, dtype=torch.float32):
    return ResNet((3, 4, 6, 3), num_classes=num_classes, generator=generator,
                  dtype=dtype)


def make_encoder(opt, generator=None, dtype=torch.float32):
    """Image encoder with fc sized to the shape + rgb latent dims."""
    out_dim = opt.arch.latent_dim_shape + opt.arch.latent_dim_rgb
    if opt.arch.enc_network == "resnet34":
        return resnet34(num_classes=out_dim, generator=generator, dtype=dtype)
    if opt.arch.enc_network == "resnet18":
        return resnet18(num_classes=out_dim, generator=generator, dtype=dtype)
    raise ValueError(opt.arch.enc_network)


def load_pretrained_npz(module, path, skip_fc=True):
    """Copy a converted torchvision state_dict (an .npz with torchvision's
    names, `scripts/convert_weights.py`) into `module`, name for name: the
    port's ResNets use those names and layouts, so nothing is transposed.
    `fc.*` is skipped with `skip_fc`, `num_batches_tracked` always (the JAX
    package keeps no such counter). An entry the module does not have, or
    one of another shape, raises."""
    state = module.state_dict()
    with np.load(path) as data:
        for name in data.files:
            if (skip_fc and name.startswith("fc.")) \
                    or name.endswith("num_batches_tracked"):
                continue
            if name not in state:
                raise KeyError(f"{path}: {name} has no counterpart in "
                               f"{type(module).__name__}")
            value = torch.from_numpy(np.asarray(data[name], np.float32))
            if value.shape != state[name].shape:
                raise ValueError(f"{path}: {name} is {tuple(value.shape)}, "
                                 f"the module's {tuple(state[name].shape)}")
            with torch.no_grad():
                state[name].copy_(value)
