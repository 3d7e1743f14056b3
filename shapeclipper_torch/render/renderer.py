"""VolSDF-style volume renderer, eval path (counterpart of
`shapeclipper_tpu/render/renderer.py` with `training=False`, no eikonal
points, `visualize=False`).

The SDF and its point gradient come from one call of
`ops/fused_sdf.py::fused_sdf_forward(compute_grad=True)` -- the Hopper kernel
on CUDA; volume normals are -density'(sdf) * grad sdf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import camera
from ..models.implicit import laplace_density, laplace_density_dsdf
from ..ops.fused_sdf import fused_sdf_forward


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor         # [B, R, 3]
    mask: torch.Tensor        # [B, R, 1]
    mask_hard: torch.Tensor   # [B, R, 1]
    depth: torch.Tensor       # [B, R, 1]
    normal: torch.Tensor      # [B, R, 3]


def _safe_normalize(x, dim=-1, eps=1e-12):
    """x / max(|x|, eps), written as x / sqrt(max(|x|^2, eps^2)) as in the JAX
    package (finite gradient at x == 0)."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def sample_z_vals(opt, n_rays, scale_dist):
    """Uniform depth samples in [dist*scale - 0.7, dist*scale + 0.7], without
    jitter (eval) -> z_vals [B, R, S]."""
    S = opt.render.n_samples_uniform
    B = scale_dist.shape[0]
    near = opt.camera.dist * scale_dist[:, None, None] - 0.7   # [B,1,1]
    far = opt.camera.dist * scale_dist[:, None, None] + 0.7
    t_vals = torch.linspace(0.0, 1.0, S, device=scale_dist.device)
    z_vals = near * (1.0 - t_vals) + far * t_vals               # [B,1,S]
    return z_vals.expand(B, n_rays, S)


def volume_rendering(z_vals, density):
    """alpha = 1 - e^{-dist*density}; T = e^{-cumsum(shifted free energy)};
    weights = alpha * T. z_vals, density [B, R, S] -> (weights, alpha)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.zeros_like(dists[..., :1])], dim=-1)
    free_energy = dists * density
    shifted = torch.cat([torch.zeros_like(free_energy[..., :1]),
                         free_energy[..., :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha * transmittance, alpha


def render(opt, sdf_network, rgb_network, beta, pose, intr, scale_dist,
           proj_latent_sdf, proj_latent_rgb):
    """Render the dense H x W rgb / mask / depth / normal maps.

    pose [B, 3, 4], intr [B, 3, 3], scale_dist [B], latents [B, C]."""
    B = pose.shape[0]
    S = opt.render.n_samples_uniform
    if opt.render.sampler != "uniform" or opt.render.normal_model != "volume":
        raise ValueError("the port renders with render.sampler=uniform and "
                         "render.normal_model=volume only; got "
                         f"{opt.render.sampler!r}, {opt.render.normal_model!r}")

    cam_loc, ray_raw = camera.get_center_and_ray(opt, pose, intr=intr)
    ray_dirs = _safe_normalize(ray_raw)
    depth_fac = 1.0 / torch.sqrt(torch.clamp(
        (ray_raw * ray_raw).sum(dim=-1, keepdim=True), min=1e-24))  # [B,R,1]
    R = ray_dirs.shape[1]
    if opt.camera.model == "perspective":
        cam_loc = cam_loc.expand(B, R, 3)

    z_vals = sample_z_vals(opt, R, scale_dist)                       # [B,R,S]
    points = cam_loc[:, :, None, :] + z_vals[..., None] * ray_dirs[:, :, None, :]
    points_flat = points.reshape(B, R * S, 3).contiguous()

    sdf, sdf_feat, grad_sdf = fused_sdf_forward(
        sdf_network, points_flat, proj_latent_sdf, compute_grad=True)
    density = laplace_density(sdf, beta).reshape(B, R, S)
    normal_flat = -laplace_density_dsdf(sdf, beta) * grad_sdf         # [B,RS,3]

    rgb = rgb_network(points_flat, proj_latent_rgb, sdf_feat).reshape(
        B, R, S, 3)

    weights, _ = volume_rendering(z_vals, density)                   # [B,R,S]
    depth_values = (weights * (z_vals * depth_fac)).sum(dim=-1, keepdim=True)
    normal = _safe_normalize(normal_flat).reshape(B, R, S, 3)
    normal_weights = weights[..., None] ** opt.reg.normal_pow
    normal_values = _safe_normalize((normal_weights * normal).sum(dim=-2))

    acc_map = weights.sum(dim=-1)                                    # [B,R]
    rgb_values = (weights[..., None] * rgb).sum(dim=-2)              # [B,R,3]
    bg = float(opt.data.bgcolor) if opt.data.bgcolor is not None else 0.0
    rgb_output = rgb_values + (1.0 - acc_map[..., None]) * bg
    mask = acc_map[..., None]
    mask_hard = (mask > 0.5).to(rgb_output.dtype)
    return RenderOutputs(rgb=rgb_output, mask=mask, mask_hard=mask_hard,
                         depth=depth_values, normal=normal_values)
