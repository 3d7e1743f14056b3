"""Serving graph: encoder -> latents -> pose -> render (counterpart of
`shapeclipper_tpu/models/graph.py`, the `training=False`, `get_loss=False`
path with sequential encoders).

`Graph` is an `nn.Module` holding every parameter under the state_dict
names that `bridge.py` produces. Inputs use the JAX package's layouts: images
[B, H, W, 3], poses [B, 3, 4].
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .. import camera
from ..render import renderer as renderlib
from ..utils.easydict import EasyDict as edict
from .estimator import Estimator
from .implicit import Density, RGBNetwork, SDFNetwork
from .layers import LatentProjection
from .resnet import make_encoder

# canonical-frame permutation applied after Rz Rx Ry (reference
# `model/graph.py:276-281`)
R_PERMUTE = ((-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0))


def _rotation(trig_azim, trig_elev, trig_theta):
    Ry = camera.azim_to_rotation_matrix(trig_azim, "trig")
    Rx = camera.elev_to_rotation_matrix(trig_elev, "trig")
    Rz = camera.roll_to_rotation_matrix(trig_theta, "trig")
    perm = torch.tensor(R_PERMUTE, device=trig_azim.device)
    return Rz @ Rx @ Ry @ perm[None]


def pose_from_trig(opt, trig_azim, trig_elev, trig_theta, scale_focal,
                   scale_dist):
    """Estimator outputs -> (pose [B,3,4], intr [B,3,3]): rotation
    Rz Rx Ry R_permute, translation [0, 0, dist * scale_dist]."""
    pose_R = camera.pose(R=_rotation(trig_azim, trig_elev, trig_theta))
    trans_z = scale_dist * opt.camera.dist
    zeros = torch.zeros_like(trans_z)
    pose_T = camera.pose(t=torch.stack([zeros, zeros, trans_z], dim=-1))
    return camera.compose([pose_R, pose_T]), camera.get_intr(opt, scale_focal)


class Graph(nn.Module):
    """Model bundle + the serving forward. `generator` seeds the
    initialisation (the port has no trained weights of its own)."""

    def __init__(self, opt, generator=None):
        super().__init__()
        self.opt = opt
        g = generator
        self.encoder = make_encoder(opt, generator=g)
        self.estimator = Estimator.from_opt(opt, generator=g)
        self.latent_proj_shape = LatentProjection(
            opt.arch.latent_dim_shape, opt.arch.impl_sdf.proj_latent_dim,
            generator=g)
        self.latent_proj_rgb = LatentProjection(
            opt.arch.latent_dim_rgb, opt.arch.impl_rgb.proj_latent_dim,
            generator=g)
        self.sdf_network = SDFNetwork.from_opt(opt, generator=g)
        self.rgb_network = RGBNetwork.from_opt(opt, generator=g)
        self.density = Density(opt.arch.impl_sdf.beta_init)

    def with_opt(self, opt):
        """A Graph that shares every parameter and buffer with this one but
        reads `opt` (the eval render resolution)."""
        view = copy.copy(self)
        view.opt = opt
        return view

    def encode(self, images):
        """Image -> (proj_latent_sdf, proj_latent_rgb, latent_raw)."""
        latent_raw = self.encoder(images)
        d = self.opt.arch.latent_dim_shape
        return (self.latent_proj_shape(latent_raw[:, :d]),
                self.latent_proj_rgb(latent_raw[:, d:]), latent_raw)

    def pred_pose(self, images):
        """Estimator -> (pose [B,3,4], intr [B,3,3], EstimatorOutputs)."""
        est = self.estimator(images)
        pose, intr = pose_from_trig(self.opt, est.trig_azim, est.trig_elev,
                                    est.trig_theta, est.scale_focal,
                                    est.scale_dist)
        return pose, intr, est

    def render(self, pose, intr, scale_dist, proj_sdf, proj_rgb):
        return renderlib.render(self.opt, self.sdf_network, self.rgb_network,
                                self.density.beta, pose, intr, scale_dist,
                                proj_sdf, proj_rgb)

    def forward(self, var, training=False, get_loss=False):
        """`var` is an EasyDict batch with `rgb_input_map` [B, H, W, 3];
        returns it with the reconstruction fields added. Only the serving
        path exists: training and losses come with a later slice."""
        if training or get_loss:
            raise NotImplementedError("the training forward is not ported")
        if any(m.training for m in self.children()):
            raise RuntimeError("call graph.eval() first: serving uses the "
                               "BatchNorm running statistics")
        opt = self.opt
        var = edict(var)
        proj_sdf, proj_rgb, _ = self.encode(var.rgb_input_map)
        pose, intr, est = self.pred_pose(var.rgb_input_map)
        var.proj_latent_sdf, var.proj_latent_rgb = proj_sdf, proj_rgb
        var.pose, var.intr, var.scale_dist = pose, intr, est.scale_dist
        var.trig_azim, var.trig_elev, var.trig_theta = (
            est.trig_azim, est.trig_elev, est.trig_theta)
        var.scale_focal = est.scale_focal
        out = self.render(pose, intr, est.scale_dist, proj_sdf, proj_rgb)
        var.rgb_recon, var.mask_recon = out.rgb, out.mask
        var.mask_hard, var.depth_recon = out.mask_hard, out.depth
        var.normal_recon = out.normal
        B = var.rgb_recon.shape[0]
        var.rgb_recon_map = var.rgb_recon.reshape(B, opt.H, opt.W, 3)
        var.mask_recon_map = var.mask_recon.reshape(B, opt.H, opt.W, 1)
        var.mask_hard_map = var.mask_hard.reshape(B, opt.H, opt.W, 1)
        var.normal_recon_map = var.normal_recon.reshape(B, opt.H, opt.W, 3)
        return var

    def get_rotate_pose(self, n_views=50):
        """[n_views, 3, 4] azimuth-rotating poses for the turntable
        (reference `model/graph.py:296-321`)."""
        opt = self.opt
        dev = self.density.beta.device
        ranges = opt.data[opt.data.dataset]
        angle_azim = torch.linspace(0, 2, n_views, device=dev)[:, None] * torch.pi
        mean_elev = (torch.zeros(n_views, 1, device=dev)
                     + (ranges.elev_range[1] + ranges.elev_range[0]) / 2 + 15)
        mean_theta = (torch.zeros(n_views, 1, device=dev)
                      + (ranges.theta_range[1] + ranges.theta_range[0]) / 2)
        angle_elev = mean_elev * torch.pi / 180
        angle_theta = mean_theta * torch.pi / 180

        def trig(a):
            return torch.cat([torch.cos(a), torch.sin(a)], 1)

        pose = camera.pose(R=_rotation(trig(angle_azim), trig(angle_elev),
                                       trig(angle_theta)))
        pose_cam = camera.pose(t=torch.tensor(
            [0.0, 0.0, float(opt.camera.dist)], device=dev))
        return camera.compose([pose, pose_cam.expand(pose.shape)])
