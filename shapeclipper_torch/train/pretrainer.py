"""The optimizer factory of `shapeclipper_tpu/train/pretrainer.py` (the
sphere-fit pretraining runner itself is not ported).
"""

from __future__ import annotations

import torch


def make_optimizer(opt, params):
    """`torch.optim.Adam` over `params` with opt.optim.lr and the
    `opt.optim.params` overrides (`betas`, `eps`). optax's and torch's Adam
    compute the same update: lr * m_hat / (sqrt(v_hat) + eps)."""
    assert opt.optim.algo.lower() == "adam", opt.optim.algo
    kwargs = {}
    for k, v in (opt.optim.get("params") or {}).items():
        if k not in ("betas", "eps"):
            raise ValueError(f"optim.params.{k} is not supported by the port")
        kwargs[k] = tuple(v) if k == "betas" else float(v)
    return torch.optim.Adam(list(params), lr=float(opt.optim.lr), **kwargs)
