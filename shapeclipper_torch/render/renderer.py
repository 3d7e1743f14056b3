"""VolSDF-style volume renderer (counterpart of
`shapeclipper_tpu/render/renderer.py`, `visualize=False`).

The SDF and its point gradient come from one fused SDF call: at eval
`fused_sdf_forward(compute_grad=True)` (K1 on CUDA, no gradients), in
training `fused_sdf_train` (K1 forward, K2 backward on CUDA). Volume normals
are -density'(sdf) * grad sdf. `implicit_dtype` (`tpu.implicit_dtype`) is
the precision of both MLPs, as the JAX package's `Graph._implicit_applies`:
with "bfloat16" the fused SDF pair takes bf16 products (`mm_dtype`, the
kernels' bf16 instantiations) and the RGB MLP runs with its parameters and
inputs cast to bfloat16, its output cast back to float32. Training renders
only the sampled rays
`ray_idx`, jitters the depth samples, and evaluates the eikonal points (R
uniform in the sample range, R near points one per ray) with the latent
detached but not the points, which depend on the predicted pose.

Random draws: a training render takes them as inputs (`draws.t_rand`
[B,R,S], `draws.eik_idx` [B,R,1], `draws.eik_uniform` [Be,R,3]); `draw` takes
them from a `torch.Generator` at the global batch (B times the world size)
and keeps this rank's rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import camera
from .. import parallel
from ..models.implicit import (cast_call, compute_dtype, laplace_density,
                               laplace_density_dsdf)
from ..ops.fused_sdf import fused_sdf_forward, fused_sdf_train
from ..utils.easydict import EasyDict as edict
from ..utils.trace import span


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor         # [B, R, 3]
    mask: torch.Tensor        # [B, R, 1]
    mask_hard: torch.Tensor   # [B, R, 1]
    depth: torch.Tensor       # [B, R, 1]
    normal: torch.Tensor      # [B, R, 3]
    grad_eikonal: torch.Tensor | None = None   # [B, 2R] when computed


def _safe_normalize(x, dim=-1, eps=1e-12):
    """x / max(|x|, eps), written as x / sqrt(max(|x|^2, eps^2)) as in the JAX
    package (finite gradient at x == 0)."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def draw(opt, n, n_rays, eikonal, generator, device, given=None, groups=1):
    """A training render's draws for the global batch of `n` samples in each
    of `groups` view groups ([query; NN_0; ...] for the merged render), in
    the order the render consumes them: t_rand [groups * n, R, S], then
    with `eikonal` eik_idx [groups * n, R, 1] and eik_uniform [n, R, 3]
    (the first group's: only the query takes eikonal points); this rank
    keeps its rows of each group (`parallel.local_rows`). A draw in `given`
    (this rank's rows) is kept and takes nothing from `generator`."""
    S = opt.render.n_samples_uniform
    rows = groups * n
    makes = [("t_rand", groups, lambda g: torch.rand(
        rows, n_rays, S, generator=g, device=device))]
    if eikonal:
        lo, hi = opt.arch.impl_sdf.eikonal_sample_range
        makes += [("eik_idx", groups, lambda g: torch.randint(
                       0, S, (rows, n_rays, 1), generator=g, device=device)),
                  ("eik_uniform", 1, lambda g: lo + (hi - lo) * torch.rand(
                      n, n_rays, 3, generator=g, device=device))]
    out = edict(given or {})
    for key, k, make in makes:
        if out.get(key) is None:
            if generator is None:
                raise ValueError(f"no draw {key!r} given and no generator "
                                 "to draw it from")
            out[key] = torch.cat([parallel.local_rows(part)
                                  for part in make(generator).chunk(k)])
    return out


def sample_z_vals(opt, n_rays, scale_dist, draws=None):
    """Uniform depth samples in [dist*scale - 0.7, dist*scale + 0.7], with a
    training render's `draws` jittered by draws.t_rand -> (z_vals [B,R,S],
    z_eik [B,R,1] or None): z_eik, where the draws hold eik_idx, is one
    jittered sample per ray, for the eikonal points."""
    S = opt.render.n_samples_uniform
    B = scale_dist.shape[0]
    dev = scale_dist.device
    near = opt.camera.dist * scale_dist[:, None, None] - 0.7   # [B,1,1]
    far = opt.camera.dist * scale_dist[:, None, None] + 0.7
    t_vals = torch.linspace(0.0, 1.0, S, device=dev)
    z_vals = (near * (1.0 - t_vals) + far * t_vals).expand(B, n_rays, S)
    if draws is None:
        return z_vals, None
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    z_vals = lower + (upper - lower) * draws.t_rand
    z_eik = None
    if draws.get("eik_idx") is not None:
        z_eik = torch.gather(z_vals, -1, draws.eik_idx.long())
    return z_vals, z_eik


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


@span("render")
def render(opt, sdf_network, rgb_network, beta, pose, intr, scale_dist,
           proj_latent_sdf, proj_latent_rgb, ray_idx=None, training=False,
           compute_eikonal=None, draws=None, implicit_dtype="float32",
           eikonal_batch=None):
    """Render rgb / mask / depth / normal at the pixels `ray_idx` [B, R]
    (the dense H x W grid when None), plus the eikonal gradient norms
    [Be, 2R] when `compute_eikonal` (default: `training`) of the first
    `Be = eikonal_batch` rows (default: all B; the merged query + neighbour
    render asks for the query's only).

    pose [B, 3, 4], intr [B, 3, 3], scale_dist [B], latents [B, C]."""
    if compute_eikonal is None:
        compute_eikonal = training
    rgb_dtype = compute_dtype(implicit_dtype)
    B = pose.shape[0]
    S = opt.render.n_samples_uniform
    if opt.render.sampler != "uniform" or opt.render.normal_model != "volume":
        raise ValueError("the port renders with render.sampler=uniform and "
                         "render.normal_model=volume only; got "
                         f"{opt.render.sampler!r}, {opt.render.normal_model!r}")

    with span("render.rays"):
        cam_loc, ray_raw = camera.get_center_and_ray(opt, pose, intr=intr,
                                                     ray_idx=ray_idx)
        ray_dirs = _safe_normalize(ray_raw)
        depth_fac = 1.0 / torch.sqrt(torch.clamp(
            (ray_raw * ray_raw).sum(dim=-1, keepdim=True),
            min=1e-24))                                          # [B,R,1]
        R = ray_dirs.shape[1]
        if opt.camera.model == "perspective":
            cam_loc = cam_loc.expand(B, R, 3)

        if training:
            keys = ("t_rand",) + (("eik_idx", "eik_uniform")
                                  if compute_eikonal else ())
            missing = [k for k in keys if (draws or {}).get(k) is None]
            if missing:
                raise ValueError(f"a training render needs the draws "
                                 f"{missing} (`draw`, models/graph.py::"
                                 "step_draws)")
        z_vals, z_eik = sample_z_vals(opt, R, scale_dist,
                                      draws if training else None)
        points = (cam_loc[:, :, None, :]
                  + z_vals[..., None] * ray_dirs[:, :, None, :])
        points_flat = points.reshape(B, R * S, 3).contiguous()

    if training:
        sdf, sdf_feat, grad_sdf = fused_sdf_train(
            sdf_network, points_flat, proj_latent_sdf,
            mm_dtype=implicit_dtype)
    else:
        sdf, sdf_feat, grad_sdf = fused_sdf_forward(
            sdf_network, points_flat, proj_latent_sdf, compute_grad=True,
            mm_dtype=implicit_dtype)

    with span("render.rgb"):
        rgb = cast_call(rgb_network, rgb_dtype, points_flat, proj_latent_rgb,
                        sdf_feat).reshape(B, R, S, 3)

    with span("render.composite"):
        density = laplace_density(sdf, beta).reshape(B, R, S)
        normal_flat = -laplace_density_dsdf(sdf, beta) * grad_sdf    # [B,RS,3]
        weights, _ = volume_rendering(z_vals, density)               # [B,R,S]
        depth_values = (weights * (z_vals * depth_fac)).sum(dim=-1,
                                                            keepdim=True)
        normal = _safe_normalize(normal_flat).reshape(B, R, S, 3)
        normal_weights = weights[..., None] ** opt.reg.normal_pow
        normal_values = _safe_normalize((normal_weights * normal).sum(dim=-2))

        acc_map = weights.sum(dim=-1)                                # [B,R]
        rgb_values = (weights[..., None] * rgb).sum(dim=-2)          # [B,R,3]
        bg = float(opt.data.bgcolor) if opt.data.bgcolor is not None else 0.0
        rgb_output = rgb_values + (1.0 - acc_map[..., None]) * bg
        mask = acc_map[..., None]
        mask_hard = (mask > 0.5).to(rgb_output.dtype)

    grad_eikonal = None
    if compute_eikonal:
        with span("render.eikonal"):
            Be = B if eikonal_batch is None else eikonal_batch
            eik_near = cam_loc[:Be] + z_eik[:Be] * ray_dirs[:Be]    # [Be,R,3]
            eik_points = torch.cat([draws.eik_uniform, eik_near],
                                   dim=1).contiguous()
            _, _, grad_eik = fused_sdf_train(sdf_network, eik_points,
                                             proj_latent_sdf[:Be],
                                             detach_latent=True,
                                             mm_dtype=implicit_dtype)
            # sqrt(max(.)) keeps the gradient finite at a zero SDF gradient
            grad_eikonal = torch.sqrt(torch.clamp(
                (grad_eik * grad_eik).sum(dim=-1), min=1e-24))      # [Be,2R]
    return RenderOutputs(rgb=rgb_output, mask=mask, mask_hard=mask_hard,
                         depth=depth_values, normal=normal_values,
                         grad_eikonal=grad_eikonal)
