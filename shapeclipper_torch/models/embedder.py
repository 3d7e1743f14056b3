"""NeRF-style positional encoding (counterpart of
`shapeclipper_tpu/models/embedder.py`).

Feature order: [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with
f_k = 2^k, k = 0..num_freqs-1.
"""

from __future__ import annotations

import torch


def posenc_dim(num_freqs, input_dims=3):
    return input_dims + 2 * num_freqs * input_dims


def positional_encoding(x, num_freqs):
    """x: [..., D] -> [..., D + 2*num_freqs*D]."""
    if num_freqs <= 0:
        return x
    feats = [x]
    for k in range(num_freqs):
        xf = x * (2.0 ** k)
        feats += [torch.sin(xf), torch.cos(xf)]
    return torch.cat(feats, dim=-1)
