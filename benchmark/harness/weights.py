"""Every parameter and BatchNorm buffer of ShapeClipper's model, named as
its state_dict names them, with the shapes a configuration gives, and
their initial values made on the device from the run's seed: one normal
draw for all of them, scaled and masked leaf by leaf after the published
initialisations (He for convolutions, LeCun for dense layers, the
estimator heads' zeroed scales, the SDF MLP's geometric sphere init,
nn.Linear's default for the RGB MLP). The program and the reference are
handed these same values."""

from __future__ import annotations

import math

import torch

RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def _resnet(prefix, stages, fc_out):
    """[(name, shape, rule)] of a BasicBlock ResNet."""
    out = [(prefix + "conv1.weight", (64, 3, 7, 7), "conv")]
    out += _bn(prefix + "bn1", 64)
    c = 64
    for i, count in enumerate(stages):
        f = 64 * 2 ** i
        for j in range(count):
            p = f"{prefix}layer{i + 1}.{j}."
            stride = 2 if (i > 0 and j == 0) else 1
            out += [(p + "conv1.weight", (f, c, 3, 3), "conv")]
            out += _bn(p + "bn1", f)
            out += [(p + "conv2.weight", (f, f, 3, 3), "conv")]
            out += _bn(p + "bn2", f)
            if c != f or stride != 1:
                out += [(p + "downsample.0.weight", (f, c, 1, 1), "conv")]
                out += _bn(p + "downsample.1", f)
            c = f
    if fc_out:
        out += [(prefix + "fc.weight", (fc_out, c), "lecun"),
                (prefix + "fc.bias", (fc_out,), "zeros")]
    return out


def _bn(name, c, scale="ones"):
    return [(name + ".weight", (c,), scale), (name + ".bias", (c,), "zeros")]


def _bottleneck(prefix, n, zero_init=False):
    return ([(prefix + "linear1.weight", (n, n), "lecun")] + _bn(prefix + "bn1", n)
            + [(prefix + "linear2.weight", (n, n), "lecun")]
            + _bn(prefix + "bn2", n, "zeros" if zero_init else "ones"))


def _projection(prefix, n, out):
    return (_bottleneck(prefix + "block0.", n) + _bottleneck(prefix + "block1.", n)
            + [(prefix + "proj.weight", (out, n), "lecun"),
               (prefix + "proj.bias", (out,), "zeros")])


def sdf_dims(cfg):
    a = cfg["arch"]["impl_sdf"]
    pe = 3 + 6 * a["pos_enc"]
    d0 = pe + a["proj_latent_dim"]
    return [d0] + [a["n_channels"]] * a["n_hidden_layers"] + [1 + a["n_channels"]]


def param_specs(cfg):
    """[(name, shape, rule)] of every parameter of the model `cfg` names."""
    arch = cfg["arch"]
    out = _resnet("encoder.", RESNET_STAGES[arch["enc_network"]],
                  arch["latent_dim_shape"] + arch["latent_dim_rgb"])
    out += _resnet("estimator.feature_extractor.", RESNET_STAGES["resnet18"],
                   None)
    for head, k in (("extr", 6), ("size", 1), ("perspect", 1)):
        out += _bottleneck(f"estimator.{head}_head.", 512, zero_init=True)
        out += [(f"estimator.{head}_fc.weight", (k, 512), f"{head}_fc"),
                (f"estimator.{head}_fc.bias", (k,), f"{head}_fc_bias")]
    out += _projection("latent_proj_shape.", arch["latent_dim_shape"],
                       arch["impl_sdf"]["proj_latent_dim"])
    out += _projection("latent_proj_rgb.", arch["latent_dim_rgb"],
                       arch["impl_rgb"]["proj_latent_dim"])
    dims = sdf_dims(cfg)
    skips = tuple(arch["impl_sdf"]["skip_connection"])
    for l in range(len(dims) - 1):
        d_in = dims[l] + (dims[0] if l in skips else 0)
        out += [(f"sdf_network.lin{l}.weight", (dims[l + 1], d_in), "sdf"),
                (f"sdf_network.lin{l}.bias", (dims[l + 1],), "sdf_bias")]
    r = arch["impl_rgb"]
    rdims = ([3 + 6 * r["pos_enc"] + r["proj_latent_dim"]
              + arch["impl_sdf"]["n_channels"]]
             + [r["n_channels"]] * r["n_hidden_layers"] + [3])
    for l in range(len(rdims) - 1):
        out += [(f"rgb_network.lin{l}.weight", (rdims[l + 1], rdims[l]), "rgb"),
                (f"rgb_network.lin{l}.bias", (rdims[l + 1],), "rgb")]
    out += [("density.beta", (), "beta")]
    return out


def buffer_names(cfg):
    """The BatchNorm layers' names (each holds running_mean, running_var,
    num_batches_tracked)."""
    return [n[:-len(".weight")] for n, _, rule in param_specs(cfg)
            if rule in ("ones", "zeros") and n.endswith(".weight")]


def _std(name, shape, rule, cfg):
    """(mean, std) of a randomly drawn leaf, or None for a constant one."""
    if rule == "conv":              # He, fan_out
        return 0.0, math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if rule == "lecun":
        return 0.0, 1.0 / math.sqrt(shape[1])
    if rule == "extr_fc":           # nn.Linear's uniform, as a normal
        return 0.0, 1.0 / math.sqrt(3.0 * shape[1])
    if rule == "rgb":
        return 0.0, 1.0 / math.sqrt(3.0 * (shape[1] if len(shape) == 2
                                           else _rgb_fan_in(name, cfg)))
    if rule == "sdf":
        last = shape[0] == 1 + cfg["arch"]["impl_sdf"]["n_channels"]
        if last:
            return math.sqrt(math.pi) / math.sqrt(shape[1]), 1e-4
        return 0.0, math.sqrt(2.0) / math.sqrt(shape[0])
    return None


def _rgb_fan_in(name, cfg):
    layer = name.split(".")[1]
    for n, shape, _ in param_specs(cfg):
        if n == f"rgb_network.{layer}.weight":
            return shape[1]
    raise KeyError(name)


def _constant(name, shape, rule, cfg, device):
    if rule == "ones":
        return torch.ones(shape, device=device)
    if rule in ("zeros", "size_fc", "size_fc_bias", "perspect_fc",
                "perspect_fc_bias"):
        return torch.zeros(shape, device=device)
    if rule == "extr_fc_bias":
        return torch.tensor([0.0, 0.0, 1.0, 0.0, 1.0, 0.0], device=device)
    if rule == "sdf_bias":
        last = shape[0] == 1 + cfg["arch"]["impl_sdf"]["n_channels"]
        value = -cfg["arch"]["impl_sdf"]["init_sphere_radius"] if last else 0.0
        return torch.full(shape, float(value), device=device)
    if rule == "beta":
        return torch.tensor(float(cfg["arch"]["impl_sdf"]["beta_init"]),
                            device=device)
    raise KeyError(f"no initial value for {name} ({rule})")


def _mask(name, w, cfg):
    """Zero what the published initialisations zero."""
    if name == "estimator.extr_fc.weight":
        w[2:] = 0.0                 # elevation and roll start at angle 0
    if name.startswith("sdf_network.") and cfg["arch"]["impl_sdf"].get(
            "geometric_init", True) and cfg["arch"]["impl_sdf"]["pos_enc"] > 0:
        l = int(name.split(".")[1][3:])
        dims = sdf_dims(cfg)
        if l == 0:
            w[:, 3:] = 0.0          # only the raw xyz inputs at first
        elif l in tuple(cfg["arch"]["impl_sdf"]["skip_connection"]):
            w[:, w.shape[1] - (dims[0] - 3):] = 0.0
    return w


def make(cfg, seed, device):
    """-> (weights {name: tensor}, buffers {name: tensor}) on `device`,
    made from `seed` by one generator on that device."""
    specs = param_specs(cfg)
    drawn = [(n, s, _std(n, s, r, cfg)) for n, s, r in specs]
    total = sum(math.prod(s) for _, s, ms in drawn if ms is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device)
    weights, off = {}, 0
    for (name, shape, rule), (_, _, ms) in zip(specs, drawn):
        if ms is None:
            weights[name] = _constant(name, shape, rule, cfg, device)
            continue
        n = math.prod(shape)
        weights[name] = _mask(name, z[off:off + n].view(shape) * ms[1] + ms[0],
                              cfg)
        off += n
    buffers = {}
    for bn in buffer_names(cfg):
        c = weights[bn + ".weight"].shape[0]
        buffers[bn + ".running_mean"] = torch.zeros(c, device=device)
        buffers[bn + ".running_var"] = torch.ones(c, device=device)
    return weights, buffers


@torch.no_grad()
def load_into(module, weights, buffers):
    """Copy `weights` and `buffers` into `module` (the program's model),
    whose parameters must be exactly `weights`' names and shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the model's parameters differ from the benchmark's: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: {tuple(p.shape)} against "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
    state = dict(module.named_buffers())
    for name, b in buffers.items():
        state[name].copy_(b)
    for name, b in state.items():
        if name.endswith("num_batches_tracked"):
            b.zero_()
