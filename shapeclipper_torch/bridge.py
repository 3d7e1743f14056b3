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
reference; the MLPs keep `lin{l}`; `category_centers` (the parameter of
`loss_weight.category_reg`, [num_classes, proj_latent_dim]) keeps its name
and layout.

A tree may be partial: only the children it holds are converted (a JAX
pretraining checkpoint keeps `sdf_network`, `latent_proj_shape` and maybe
`estimator`), and an empty subtree counts as absent (the frozen branch of a
masked optax state). Without `batch_stats` only the parameters are
converted, which is how the Adam moments, shaped as the parameters, map
(`adam_state_from_optax`). `clip_state_from_flax` maps the JAX CLIP tower.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _prune(tree):
    """Drop empty subtrees: optax stores nothing for a masked-out leaf."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        v = _prune(v)
        if not (isinstance(v, dict) and not v):
            out[k] = v
    return out


def _dense(out, prefix, p):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out, prefix, p):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(out, prefix, p, s):
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    if s is not None:
        out[f"{prefix}.running_mean"] = _t(s["mean"])
        out[f"{prefix}.running_var"] = _t(s["var"])
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0,
                                                            dtype=torch.long)


def _sub(s, name):
    return None if s is None else s[name]


def _resnet(out, prefix, p, s):
    for name in p:
        if name == "conv1":
            _conv(out, f"{prefix}.conv1", p[name])
        elif name == "bn1":
            _bn(out, f"{prefix}.bn1", p[name], _sub(s, name))
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
                    _bn(out, f"{base}.{sub}", leaf, _sub(_sub(s, name), sub))
                elif sub == "downsample_conv":
                    _conv(out, f"{base}.downsample.0", leaf)
                elif sub == "downsample_bn":
                    _bn(out, f"{base}.downsample.1", leaf,
                        _sub(_sub(s, name), sub))
                else:
                    raise KeyError(f"unexpected block entry {base}/{sub}")


def _bottleneck(out, prefix, p, s):
    for name, leaf in p.items():
        if name.startswith("linear"):
            _dense(out, f"{prefix}.{name}", leaf)
        elif name.startswith("bn"):
            _bn(out, f"{prefix}.{name}", leaf, _sub(s, name))
        else:
            raise KeyError(f"unexpected entry {prefix}/{name}")


def _latent_proj(out, prefix, p, s):
    for name, leaf in p.items():
        if name == "proj":
            _dense(out, f"{prefix}.proj", leaf)
        else:
            _bottleneck(out, f"{prefix}.{name}", leaf, _sub(s, name))


def _estimator(out, p, s):
    for name, leaf in p.items():
        if name == "ResNet_0":
            _resnet(out, "estimator.feature_extractor", leaf, _sub(s, name))
        elif name.endswith("_head"):
            _bottleneck(out, f"estimator.{name}", leaf, _sub(s, name))
        elif name.endswith("_fc"):
            _dense(out, f"estimator.{name}", leaf)
        else:
            raise KeyError(f"unexpected entry estimator/{name}")


def state_dict_from_flax(params, batch_stats=None):
    """JAX `{params, batch_stats}` trees (either may be partial) -> the port
    Graph's state_dict for the children present; without `batch_stats`,
    the parameters only."""
    params = _prune(params)
    stats = None if batch_stats is None else _prune(batch_stats)
    out = {}
    for name, p in params.items():
        s = None if stats is None else stats.get(name, {})
        if name == "encoder":
            _resnet(out, name, p, s)
        elif name == "estimator":
            _estimator(out, p, s)
        elif name in ("latent_proj_shape", "latent_proj_rgb"):
            _latent_proj(out, name, p, s)
        elif name in ("sdf_network", "rgb_network"):
            for lin, leaf in p.items():
                _dense(out, f"{name}.{lin}", leaf)
        elif name == "density":
            out["density.beta"] = _t(p["beta"])
        elif name == "category_centers":
            out[name] = _t(p)
        else:
            raise KeyError(f"unexpected top-level entry {name}")
    return out


def mlp_state_from_flax(params_mlp):
    """One MLP's flax params ({lin{l}: {kernel, bias}}) -> its state_dict."""
    out = {}
    for lin, p in params_mlp.items():
        _dense(out, lin, p)
    return out


def adam_state_from_optax(opt_state, names, optimizer):
    """The serialized optax state of the JAX package's `make_optimizer`
    (`inner_states/train/inner_state/0/{count, mu, nu}`; mu and nu hold the
    trainable subtree only) -> a state_dict of `optimizer`, the port's Adam
    over the parameters `names` (their state_dict names, in the
    optimizer's order): mu -> exp_avg, nu -> exp_avg_sq (transposed as the
    weights), count -> every parameter's float32 `step`. The param_groups
    (lr, betas, eps) are the optimizer's own. Raises when a parameter has
    no moments or a moment no parameter."""
    adam = opt_state["inner_states"]["train"]["inner_state"]["0"]
    exp_avg = state_dict_from_flax(adam["mu"])
    exp_avg_sq = state_dict_from_flax(adam["nu"])
    groups = optimizer.state_dict()["param_groups"]
    assert sum(len(g["params"]) for g in groups) == len(names)
    missing = [n for n in names if n not in exp_avg]
    extra = sorted(set(exp_avg) - set(names))
    if missing or extra:
        raise KeyError(f"optax moments do not match the parameters: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    step = float(np.asarray(adam["count"]))
    state = {i: dict(step=torch.tensor(step, dtype=torch.float32),
                     exp_avg=exp_avg[n], exp_avg_sq=exp_avg_sq[n])
             for i, n in enumerate(names)}
    return dict(state=state, param_groups=groups)


# ------------------------------------------------------------------- CLIP
def clip_state_from_flax(params):
    """The JAX `CLIPVisionTower` params -> the port tower's state_dict
    (OpenAI's `visual.*` names without the prefix): the patch conv HWIO ->
    OIHW; per block the query / key / value kernels [W, heads, head_dim]
    -> in_proj_weight [3W, W] and their biases -> in_proj_bias, `out`
    [heads, head_dim, W] -> out_proj.weight [W, W], Dense [in, out] ->
    [out, in]; LayerNorm scale -> weight."""
    p = _prune(params)
    out = dict(class_embedding=_t(p["class_embedding"]),
               positional_embedding=_t(p["positional_embedding"]),
               proj=_t(p["proj"]))
    _conv(out, "conv1", p["patch_embed"])

    def ln(prefix, leaf):
        out[f"{prefix}.weight"] = _t(leaf["scale"])
        out[f"{prefix}.bias"] = _t(leaf["bias"])

    ln("ln_pre", p["ln_pre"])
    ln("ln_post", p["ln_post"])
    n_layers = sum(1 for k in p if re.fullmatch(r"block\d+", k))
    for i in range(n_layers):
        b, t = p[f"block{i}"], f"transformer.resblocks.{i}"
        ln(f"{t}.ln_1", b["ln_1"])
        ln(f"{t}.ln_2", b["ln_2"])
        attn = b["attn"]
        width = np.asarray(attn["query"]["kernel"]).shape[0]
        out[f"{t}.attn.in_proj_weight"] = torch.cat([
            _t(np.asarray(attn[k]["kernel"]).reshape(width, width).T)
            for k in ("query", "key", "value")])
        out[f"{t}.attn.in_proj_bias"] = torch.cat([
            _t(np.asarray(attn[k]["bias"]).reshape(width))
            for k in ("query", "key", "value")])
        out[f"{t}.attn.out_proj.weight"] = _t(
            np.asarray(attn["out"]["kernel"]).reshape(width, width).T)
        out[f"{t}.attn.out_proj.bias"] = _t(attn["out"]["bias"])
        _dense(out, f"{t}.mlp.c_fc", b["mlp_fc"])
        _dense(out, f"{t}.mlp.c_proj", b["mlp_proj"])
    return out
