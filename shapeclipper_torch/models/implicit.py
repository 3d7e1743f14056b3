"""Conditional implicit fields: SDF MLP, RGB MLP and the Laplace density
(counterpart of `shapeclipper_tpu/models/implicit.py`).

Parameters follow the reference names (`lin{l}.weight` [out, in],
`lin{l}.bias`). The latent enters every layer that reads it as a per-sample
bias (the factored form): a [B, C] latent is multiplied once by its slice of
the layer's weight and broadcast over the points, instead of being repeated
per point and concatenated.

On the serving path the SDF network is evaluated through
`ops/fused_sdf.py::fused_sdf_forward` (the Hopper kernel on CUDA); its
`forward` here is the plain module, and `sdf_with_gradient` (autograd) is the
test oracle for the kernel's point gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .embedder import posenc_dim, positional_encoding

BETA_MIN = 1e-4


# ---------------------------------------------------------------------------
# Laplace density (VolSDF)
# ---------------------------------------------------------------------------

def laplace_beta(beta_param, beta_min=BETA_MIN):
    return beta_param.abs() + beta_min


def laplace_density(sdf, beta_param, beta_min=BETA_MIN):
    """alpha * (0.5 e^{-s/b}) for s>=0 ; alpha * (1 - 0.5 e^{s/b}) for s<0."""
    beta = laplace_beta(beta_param, beta_min)
    alpha = 1.0 / beta
    e = torch.exp(-sdf.abs() / beta)
    return alpha * torch.where(sdf >= 0, 0.5 * e, 1.0 - 0.5 * e)


def laplace_density_dsdf(sdf, beta_param, beta_min=BETA_MIN):
    """d(density)/d(sdf) = -alpha/(2 beta) * e^{-|s|/beta}."""
    beta = laplace_beta(beta_param, beta_min)
    alpha = 1.0 / beta
    return -(alpha / (2.0 * beta)) * torch.exp(-sdf.abs() / beta)


class Density(nn.Module):
    """Holds the learnable Laplace `beta` (state_dict key `density.beta`)."""

    def __init__(self, beta_init):
        super().__init__()
        self.beta = nn.Parameter(torch.tensor(float(beta_init)))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _torch_default_init(lin, generator=None):
    """nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
    weight and the bias, drawn from `generator`."""
    bound = 1.0 / math.sqrt(lin.weight.shape[1])
    nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
    nn.init.uniform_(lin.bias, -bound, bound, generator=generator)


def _symmetric_posenc(points, posenc_res, force_symmetry):
    if force_symmetry:
        # |x0| as x0 * sign(x0) with sign(0) = 1: the JAX package's
        # d|x|/dx at 0 is 1, torch's 0
        x0 = points[..., :1]
        sign = torch.where(x0 < 0, -1.0, 1.0).to(x0.dtype)
        points = torch.cat([x0 * sign, points[..., 1:]], dim=-1)
    if posenc_res > 0:
        points = positional_encoding(points, posenc_res)
    return points


def factored_linear(lin, segments):
    """`lin` applied to the virtual concatenation of `segments`, a list of
    (tensor, scale) with tensors [B, N, k] (per point) or [B, k] (per sample,
    broadcast over the points); the concatenation is never built."""
    out = None
    offset = 0
    for arr, scale in segments:
        k = arr.shape[-1]
        w = lin.weight[:, offset:offset + k]
        if scale != 1.0:
            w = w * scale
        y = F.linear(arr, w)
        if arr.dim() == 2:
            y = y[:, None, :]
        out = y if out is None else out + y
        offset += k
    assert offset == lin.in_features, (offset, lin.in_features)
    return out + lin.bias


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name):
    """A `tpu.*_dtype` value (None: float32) -> the torch dtype."""
    name = name or "float32"
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def cast_call(module, dtype, *inputs):
    """`module(*inputs)` with its parameters and inputs cast to `dtype`, the
    output cast to float32: the JAX package's compute-cast apply
    (`Graph._implicit_applies`). Gradients reach the float32 parameters
    through the casts."""
    if dtype == torch.float32:
        return module(*inputs)
    params = {k: v.to(dtype) for k, v in module.named_parameters()}
    out = torch.func.functional_call(module, params,
                                     tuple(x.to(dtype) for x in inputs))
    return out.float()


def _softplus100(x):
    # softplus with beta=100 (reference `model/implicit.py:136`)
    return F.softplus(100.0 * x) / 100.0


# ---------------------------------------------------------------------------
# SDF network
# ---------------------------------------------------------------------------

class SDFNetwork(nn.Module):
    """Conditional SDF field: points [B, N, 3] + latent [B, C] (or
    [B, N, C]) -> [B, N, 1 + n_channels] = [sdf, feature]."""

    def __init__(self, proj_latent_dim=64, n_hidden=5, n_channels=64,
                 skip_in=(1, 2), posenc_res=6, force_symmetry=True,
                 geometric_init=True, init_sphere_radius=0.5, generator=None):
        super().__init__()
        self.proj_latent_dim = proj_latent_dim
        self.n_hidden = n_hidden
        self.n_channels = n_channels
        self.skip_in = tuple(skip_in)
        self.posenc_res = posenc_res
        self.force_symmetry = force_symmetry
        self.geometric_init = geometric_init
        self.init_sphere_radius = init_sphere_radius
        dims = self.dims()
        for l in range(len(dims) - 1):
            in_dim = dims[l] + (dims[0] if l in self.skip_in else 0)
            setattr(self, f"lin{l}", nn.Linear(in_dim, dims[l + 1]))
        self.reset_parameters(generator)

    @staticmethod
    def from_opt(opt, generator=None):
        a = opt.arch.impl_sdf
        if a.weight_norm:
            raise ValueError("weight_norm is not supported (off in all configs)")
        return SDFNetwork(
            proj_latent_dim=a.proj_latent_dim,
            n_hidden=a.n_hidden_layers,
            n_channels=a.n_channels,
            skip_in=tuple(a.skip_connection),
            posenc_res=a.pos_enc,
            force_symmetry=opt.arch.force_symmetry,
            geometric_init=a.geometric_init,
            init_sphere_radius=a.init_sphere_radius,
            generator=generator,
        )

    def dims(self):
        pe = posenc_dim(self.posenc_res) if self.posenc_res > 0 else 3
        d0 = pe + self.proj_latent_dim
        return [d0] + [self.n_channels] * self.n_hidden + [1 + self.n_channels]

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Geometric sphere init (reference `model/implicit.py:114-128`), or
        nn.Linear's default when `geometric_init` is off."""
        dims = self.dims()
        num_layers = len(dims)
        for l in range(num_layers - 1):
            lin = getattr(self, f"lin{l}")
            if not self.geometric_init:
                _torch_default_init(lin, generator)
                continue
            out_dim, in_dim = lin.weight.shape
            if l == num_layers - 2:
                nn.init.normal_(lin.weight, math.sqrt(math.pi) / math.sqrt(in_dim),
                                0.0001, generator=generator)
                lin.bias.fill_(-self.init_sphere_radius)
                continue
            nn.init.normal_(lin.weight, 0.0, math.sqrt(2.0) / math.sqrt(out_dim),
                            generator=generator)
            lin.bias.zero_()
            if self.posenc_res > 0 and l == 0:
                lin.weight[:, 3:] = 0.0     # only raw-xyz inputs are nonzero
            elif self.posenc_res > 0 and l in self.skip_in:
                # zero the skip copy of [posenc tail, latent]
                lin.weight[:, in_dim - (dims[0] - 3):] = 0.0

    def forward(self, points, latent):
        x_in = _symmetric_posenc(points, self.posenc_res, self.force_symmetry)
        inv_sqrt2 = 1.0 / math.sqrt(2.0)
        num_layers = len(self.dims())
        x = None
        for l in range(num_layers - 1):
            if l == 0:
                segments = [(x_in, 1.0), (latent, 1.0)]
            elif l in self.skip_in:
                segments = [(x, inv_sqrt2), (x_in, inv_sqrt2),
                            (latent, inv_sqrt2)]
            else:
                segments = [(x, 1.0)]
            x = factored_linear(getattr(self, f"lin{l}"), segments)
            if l < num_layers - 2:
                x = _softplus100(x)
        return x


def sdf_with_gradient(sdf_network, points, latent):
    """(sdf, feature, d sdf / d points) by autograd; the oracle that the
    fused kernel's forward-mode gradient is held against."""
    with torch.enable_grad():
        pts = points.detach().requires_grad_(True)
        out = sdf_network(pts, latent)
        sdf, feat = out[..., :1], out[..., 1:]
        (grad,) = torch.autograd.grad(sdf.sum(), pts)
    return sdf.detach(), feat.detach(), grad


# ---------------------------------------------------------------------------
# RGB network
# ---------------------------------------------------------------------------

class RGBNetwork(nn.Module):
    """RGB field on [posenc(xyz), rgb latent, sdf feature] -> sigmoid RGB."""

    def __init__(self, proj_latent_dim=64, n_hidden=3, n_channels=64,
                 n_sdf_channels=64, posenc_res=6, force_symmetry=True,
                 generator=None):
        super().__init__()
        self.posenc_res = posenc_res
        self.force_symmetry = force_symmetry
        pe = posenc_dim(posenc_res) if posenc_res > 0 else 3
        dims = ([pe + proj_latent_dim + n_sdf_channels]
                + [n_channels] * n_hidden + [3])
        self.num_layers = len(dims)
        for l in range(len(dims) - 1):
            lin = nn.Linear(dims[l], dims[l + 1])
            _torch_default_init(lin, generator)
            setattr(self, f"lin{l}", lin)

    @staticmethod
    def from_opt(opt, generator=None):
        a = opt.arch.impl_rgb
        if a.weight_norm:
            raise ValueError("weight_norm is not supported (off in all configs)")
        return RGBNetwork(
            proj_latent_dim=a.proj_latent_dim,
            n_hidden=a.n_hidden_layers,
            n_channels=a.n_channels,
            n_sdf_channels=opt.arch.impl_sdf.n_channels,
            posenc_res=a.pos_enc,
            force_symmetry=opt.arch.force_symmetry,
            generator=generator,
        )

    def forward(self, points, latent, sdf_feature):
        x_in = _symmetric_posenc(points, self.posenc_res, self.force_symmetry)
        x = None
        for l in range(self.num_layers - 1):
            segments = ([(x_in, 1.0), (latent, 1.0), (sdf_feature, 1.0)]
                        if l == 0 else [(x, 1.0)])
            x = factored_linear(getattr(self, f"lin{l}"), segments)
            if l < self.num_layers - 2:
                x = torch.relu(x)
        return torch.sigmoid(x)
