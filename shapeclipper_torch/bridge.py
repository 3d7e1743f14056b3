"""JAX parameter trees -> the port's state_dict.

Takes the JAX package's `params` and `batch_stats` as nested dicts of numpy
arrays (`np.asarray` of the flax trees) and returns the state_dict of
`shapeclipper_torch.models.graph.Graph` as torch tensors. Rules:

  * flax Dense kernel [in, out] -> torch Linear weight [out, in]
  * flax Conv kernel HWIO -> torch Conv2d weight OIHW
  * BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var (+ num_batches_tracked = 0)

Names: the ResNets use torchvision's (the names `scripts/convert_weights.py`
keeps: `conv1`, `bn1`, `layer{i}.{j}.conv1`, `layer{i}.{j}.downsample.{0,1}`,
`fc`); the estimator backbone is `estimator.feature_extractor` as in the
reference; the MLPs keep `lin{l}`. `category_centers` (a training-only
parameter) is not part of the serving graph and is skipped.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(out, prefix, p):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out, prefix, p):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(out, prefix, p, s):
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _resnet(out, prefix, p, s):
    for name in p:
        if name == "conv1":
            _conv(out, f"{prefix}.conv1", p[name])
        elif name == "bn1":
            _bn(out, f"{prefix}.bn1", p[name], s[name])
        elif name == "fc":
            _dense(out, f"{prefix}.fc", p[name])
        else:
            m = re.fullmatch(r"layer(\d)_block(\d+)", name)
            if m is None:
                raise KeyError(f"unexpected ResNet entry {prefix}/{name}")
            base = f"{prefix}.layer{m.group(1)}.{m.group(2)}"
            for sub, leaf in p[name].items():
                if sub.startswith("conv"):
                    _conv(out, f"{base}.{sub}", leaf)
                elif sub.startswith("bn"):
                    _bn(out, f"{base}.{sub}", leaf, s[name][sub])
                elif sub == "downsample_conv":
                    _conv(out, f"{base}.downsample.0", leaf)
                elif sub == "downsample_bn":
                    _bn(out, f"{base}.downsample.1", leaf, s[name][sub])
                else:
                    raise KeyError(f"unexpected block entry {base}/{sub}")


def _bottleneck(out, prefix, p, s):
    _dense(out, f"{prefix}.linear1", p["linear1"])
    _bn(out, f"{prefix}.bn1", p["bn1"], s["bn1"])
    _dense(out, f"{prefix}.linear2", p["linear2"])
    _bn(out, f"{prefix}.bn2", p["bn2"], s["bn2"])


def _latent_proj(out, prefix, p, s):
    _bottleneck(out, f"{prefix}.block0", p["block0"], s["block0"])
    _bottleneck(out, f"{prefix}.block1", p["block1"], s["block1"])
    _dense(out, f"{prefix}.proj", p["proj"])


def state_dict_from_flax(params, batch_stats):
    """JAX `{params, batch_stats}` trees -> the port Graph's state_dict."""
    out = {}
    _resnet(out, "encoder", params["encoder"], batch_stats["encoder"])
    est_p, est_s = params["estimator"], batch_stats["estimator"]
    _resnet(out, "estimator.feature_extractor", est_p["ResNet_0"],
            est_s["ResNet_0"])
    for head in ("extr", "size", "perspect"):
        _bottleneck(out, f"estimator.{head}_head", est_p[f"{head}_head"],
                    est_s[f"{head}_head"])
        _dense(out, f"estimator.{head}_fc", est_p[f"{head}_fc"])
    for name in ("latent_proj_shape", "latent_proj_rgb"):
        _latent_proj(out, name, params[name], batch_stats[name])
    for name in ("sdf_network", "rgb_network"):
        for lin, p in params[name].items():
            _dense(out, f"{name}.{lin}", p)
    out["density.beta"] = _t(params["density"]["beta"])
    return out


def mlp_state_from_flax(params_mlp):
    """One MLP's flax params ({lin{l}: {kernel, bias}}) -> its state_dict."""
    out = {}
    for lin, p in params_mlp.items():
        _dense(out, lin, p)
    return out
