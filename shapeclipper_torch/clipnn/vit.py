"""CLIP ViT image tower (counterpart of `shapeclipper_tpu/clipnn/vit.py`).

The OpenAI CLIP visual transformer that the reference annotator uses
(reference `CLIP_anno.py:16` loads "ViT-L/14"): patch conv -> [CLS] +
positional embeddings -> pre-LN transformer with QuickGELU MLPs -> ln_post
on the CLS token -> linear projection. The parameters carry OpenAI's
`visual.*` state_dict names without the prefix, so `load_clip_npz` loads a
converted state_dict (.npz) strictly; without a weights file the tower runs
from a seeded initialisation (annotation quality is then meaningless, but
the pipeline runs end to end).

Attention is plain float32 matmuls and a softmax (the JAX tower has no
kernel here). `clip_preprocess`, the mean and std and `VIT_CONFIGS` are
copies of the JAX package's.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

VIT_CONFIGS = {
    # name: (patch, width, layers, heads, embed_dim)
    "vit_l14": (14, 1024, 24, 16, 768),
    "vit_b32": (32, 768, 12, 12, 512),
    "vit_b16": (16, 768, 12, 12, 512),
}


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def clip_preprocess(rgb):
    """[H, W, 3] float in [0,1] -> CLIP-normalized (resize is done by the
    dataset pipeline)."""
    return (np.asarray(rgb, np.float32) - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


def _lecun_normal(shape, generator):
    """flax's default kernel init: variance 1 / fan_in (torch layout
    [out, in, ...])."""
    fan_in = math.prod(shape[1:])
    return torch.randn(shape, generator=generator) / math.sqrt(fan_in)


def _linear(n_in, n_out, generator):
    lin = nn.Linear(n_in, n_out)
    with torch.no_grad():
        lin.weight.copy_(_lecun_normal(lin.weight.shape, generator))
        lin.bias.zero_()
    return lin


class MultiheadAttention(nn.Module):
    """Self-attention under torch's `nn.MultiheadAttention` names
    (in_proj_weight [3W, W], in_proj_bias, out_proj)."""

    def __init__(self, width, heads, generator=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.cat(
            [_lecun_normal((width, width), generator) for _ in range(3)]))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = _linear(width, width, generator)

    def forward(self, x):
        B, T, W = x.shape
        hd = W // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, T, self.heads, hd).transpose(1, 2)
                   for t in qkv.split(W, dim=-1))          # [B, h, T, hd]
        att = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
        y = (att @ v).transpose(1, 2).reshape(B, T, W)
        return self.out_proj(y)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads, generator=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads, generator)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict(
            c_fc=_linear(width, 4 * width, generator),
            c_proj=_linear(4 * width, width, generator)))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        y = self.mlp.c_proj(quick_gelu(self.mlp.c_fc(self.ln_2(x))))
        return x + y


class Transformer(nn.Module):
    def __init__(self, width, layers, heads, generator=None):
        super().__init__()
        self.resblocks = nn.Sequential(*[
            ResidualAttentionBlock(width, heads, generator)
            for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


class CLIPVisionTower(nn.Module):
    """images [B, H, W, 3] CLIP-normalised -> [B, embed_dim] float32. The
    patch conv pads as flax's "SAME" (nothing where the patch divides the
    image), so the token count is ceil(H / patch) * ceil(W / patch) + 1."""

    def __init__(self, image_size, patch_size=14, width=1024, layers=24,
                 heads=16, embed_dim=768, generator=None):
        super().__init__()
        g = generator
        self.patch_size = patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        with torch.no_grad():
            self.conv1.weight.copy_(_lecun_normal(self.conv1.weight.shape, g))
        n_tokens = math.prod(-(-s // patch_size) for s in image_size) + 1
        scale = width ** -0.5
        self.class_embedding = nn.Parameter(
            torch.randn(width, generator=g) * scale)
        self.positional_embedding = nn.Parameter(
            torch.randn(n_tokens, width, generator=g) * scale)
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, layers, heads, g)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(
            torch.randn(width, embed_dim, generator=g) * scale)

    @staticmethod
    def from_name(name, image_size, generator=None):
        patch, width, layers, heads, embed = VIT_CONFIGS[name]
        return CLIPVisionTower(image_size, patch_size=patch, width=width,
                               layers=layers, heads=heads, embed_dim=embed,
                               generator=generator)

    def forward(self, images):
        B = images.shape[0]
        x = images.float().permute(0, 3, 1, 2)
        p = self.patch_size
        pads = [(-(-s // p) - 1) * p + p - s for s in x.shape[2:]]
        if any(pads):
            # flax "SAME": the lower side gets the smaller half
            x = F.pad(x, (pads[1] // 2, pads[1] - pads[1] // 2,
                          pads[0] // 2, pads[0] - pads[0] // 2))
        x = self.conv1(x).flatten(2).transpose(1, 2)       # [B, N, W]
        cls = self.class_embedding.expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0])
        return x @ self.proj


def load_clip_npz(tower, path):
    """Load a converted OpenAI CLIP state_dict (.npz) into `tower`: its
    `visual.*` entries with the prefix stripped, strictly."""
    prefix = "visual."
    with np.load(path) as data:
        state = {k[len(prefix):]: torch.from_numpy(
                     np.array(data[k], dtype=np.float32))
                 for k in data.files if k.startswith(prefix)}
    tower.load_state_dict(state, strict=True)
    return tower
