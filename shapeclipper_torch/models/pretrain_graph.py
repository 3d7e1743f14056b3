"""Sphere-initialisation pretraining graph (counterpart of
`shapeclipper_tpu/models/pretrain_graph.py`).

Random latents ~ N(0, pre.latent_std) replace the encoder's output; the SDF
MLP is fit to the analytic sphere SDF ||x|| - pre.radius on uniform points,
through the plain `SDFNetwork.forward` as the JAX package (no fused kernel:
the loss reads no spatial gradient); optionally the viewpoint estimator's
azimuth distribution is pushed toward uniform with a 1-D Wasserstein loss
on real images.
"""

from __future__ import annotations

import torch

from .. import losses as L
from ..utils.easydict import EasyDict as edict
from .graph import Graph


class PretrainGraph(Graph):
    def forward(self, var, training=True, draws=None, generator=None):
        """`var` holds `rgb_input_map` [B, H, W, 3] when pre.viewpoint is
        set (else it may be empty) -> (var, loss). BatchNorm follows the
        module's mode, which must match `training`. `draws` may give the
        step's two random draws: `latent` [B, latent_dim_shape +
        latent_dim_rgb], already scaled by pre.latent_std (only the shape
        part is used), and `points` [B, pre.sample_points, 3] in
        pre.sample_range; an absent one is drawn from `generator`."""
        opt = self.opt
        if any(m.training != training for m in self.children()):
            raise RuntimeError(f"call graph.train({training}) first: "
                               "BatchNorm follows the module's mode")
        var = edict(var)
        draws = draws or edict()
        dev = self.density.beta.device
        B = (var.rgb_input_map.shape[0] if "rgb_input_map" in var
             else opt.batch_size)
        latent_raw = draws.get("latent")
        if latent_raw is None:
            latent_dim = opt.arch.latent_dim_shape + opt.arch.latent_dim_rgb
            latent_raw = torch.randn(B, latent_dim, generator=generator,
                                     device=dev) * opt.pre.latent_std
        latent_shape = latent_raw[:, :opt.arch.latent_dim_shape]
        var.proj_latent_sdf = self.latent_proj_shape(latent_shape)

        loss = edict(all=0.0)
        if opt.pre.density:
            loss.sdf = self.get_sdf_loss(var.proj_latent_sdf,
                                         draws.get("points"), generator)
            loss.all = loss.all + loss.sdf
        if opt.pre.viewpoint:
            est = self.estimator(var.rgb_input_map)
            loss.w_dist = L.cam_uniform_loss(est.trig_azim, emd_p=1)
            loss.all = loss.all + loss.w_dist
        return var, loss

    def get_sdf_loss(self, proj_latent_sdf, points=None, generator=None):
        """MSE(sdf(x), ||x|| - radius) on pre.sample_points uniform points
        per batch element (reference `model/pretrainer.py:174-181`)."""
        opt = self.opt
        if points is None:
            lo, hi = opt.pre.sample_range
            points = lo + (hi - lo) * torch.rand(
                proj_latent_sdf.shape[0], opt.pre.sample_points, 3,
                generator=generator, device=proj_latent_sdf.device)
        sdf = self.sdf_network(points, proj_latent_sdf)[..., :1]
        sdf_gt = torch.linalg.vector_norm(points, dim=-1,
                                          keepdim=True) - opt.pre.radius
        return L.mse_loss(sdf, sdf_gt)
