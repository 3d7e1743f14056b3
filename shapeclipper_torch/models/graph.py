"""Computation graph: encoder -> latents -> pose -> render (-> losses)
(counterpart of `shapeclipper_tpu/models/graph.py`).

`Graph` is an `nn.Module` holding every parameter under the state_dict
names that `bridge.py` produces. Inputs use the JAX package's layouts: images
[B, H, W, 3], poses [B, 3, 4], neighbour stacks [B, K, ...].

Two paths: serving (`training=False`, eval-mode BatchNorm) and the training
forward (`training=True`) with the JAX package's `Graph.forward` programs,
picked by the three `tpu.merge_*` flags (each true when absent, as there;
`merge_flags`): `merge_encoders` runs the query and every neighbour view
through ONE ResNet34 and ONE ResNet18 call, `merge_flip_estimator` puts the
horizontally flipped cam_sym pass into the query's ResNet18 call, and
`merge_nn_render` renders the query and every neighbour view in ONE render
over (1 + V) * B views. Each grouped call normalises each view group with
its own BatchNorm moments (`layers.bn_groups`), so the merged step computes
what the sequential one does (flags false: query encode, estimator, render,
then per neighbour view encode, estimator and render); the BatchNorm
running statistics update query first, then each view, in both. BatchNorm
follows the module's mode: `graph.train()` for full steps, `graph.eval()`
for the camera phase (the JAX `bn_eval`). Train-mode BatchNorm follows
`tpu.bn_mode` as the JAX package's `_apply_bn`: `global` moments over the
whole batch (summed over the ranks under data parallelism), or
`per_replica` moments over `tpu.bn_replicas` contiguous blocks of each view
group (default: the world size) with the running statistics from block 0.
The port ignores `tpu.sdf_grad_mode`, `tpu.fold_eikonal` and
`tpu.remat_renderer`.

Precision follows the JAX package's two keys. `tpu.encoder_dtype` is the
compute dtype of the encoder's ResNet34 and the estimator's ResNet18
(BatchNorm in float32, parameters float32); the latent projections and the
heads stay float32. `tpu.implicit_dtype` is that of the SDF and RGB MLPs in
every render (`renderer.render`): bf16 products in the fused SDF pair, a
bf16 RGB MLP. The dense evaluation grid stays float32 (the JAX package's
raw `sdf_network.apply`).

Random draws (stratified jitter, eikonal points, the Gumbel noise of the
neighbour selection) are optional inputs in `draws`; `step_draws` takes an
absent one from `generator` at the global batch, in the order a one-process
step consumes them, and this rank keeps its own rows. The merged render
takes one draw over its (1 + V) view groups (`draws.render`); given the
sequential renders' draws instead (`render` and `render_NN`), it takes the
same rows re-sliced (`merged_render_draws`).
`loss_weight.category_reg` adds the `category_centers` parameter
[num_classes, proj_latent_dim] and its loss.
"""

from __future__ import annotations

import copy
import os

import torch
from torch import nn

from .. import camera
from .. import losses as L
from .. import parallel
from ..render import renderer as renderlib
from ..utils.easydict import EasyDict as edict
from .estimator import Estimator
from .implicit import Density, RGBNetwork, SDFNetwork, compute_dtype
from .layers import (LatentProjection, batch_stats_frozen, bn_groups,
                     set_bn_mode)
from ..utils.log import log
from ..utils.trace import span
from .resnet import load_pretrained_npz, make_encoder

# canonical-frame permutation applied after Rz Rx Ry (reference
# `model/graph.py:276-281`)
R_PERMUTE = ((-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0))


def _rotation(trig_azim, trig_elev, trig_theta):
    Ry = camera.azim_to_rotation_matrix(trig_azim, "trig")
    Rx = camera.elev_to_rotation_matrix(trig_elev, "trig")
    Rz = camera.roll_to_rotation_matrix(trig_theta, "trig")
    # a host constant copied to the card: the copy waits for the stream
    with span("sync.const"):
        perm = torch.tensor(R_PERMUTE, device=trig_azim.device)
    return Rz @ Rx @ Ry @ perm[None]


def _rows(est, lo, hi):
    """Rows lo:hi of every field of EstimatorOutputs."""
    return type(est)(*(t[lo:hi] for t in est))


def pose_from_trig(opt, trig_azim, trig_elev, trig_theta, scale_focal,
                   scale_dist):
    """Estimator outputs -> (pose [B,3,4], intr [B,3,3]): rotation
    Rz Rx Ry R_permute, translation [0, 0, dist * scale_dist]."""
    pose_R = camera.pose(R=_rotation(trig_azim, trig_elev, trig_theta))
    trans_z = scale_dist * opt.camera.dist
    zeros = torch.zeros_like(trans_z)
    pose_T = camera.pose(t=torch.stack([zeros, zeros, trans_z], dim=-1))
    return camera.compose([pose_R, pose_T]), camera.get_intr(opt, scale_focal)


def merge_flags(opt, var, nn_active):
    """(merge_encoders, merge_flip_estimator, merge_nn_render) of a training
    step on `var`, under the JAX package's conditions (`Graph.forward`):
    the encoder and render merges need the neighbour branch, the render
    merge sampled rays for the query and the views, the flip merge cam_sym;
    each flag is true when absent."""
    tpu = opt.get("tpu", {})
    enc = nn_active and tpu.get("merge_encoders", True)
    flip = (opt.loss_weight.get("cam_sym") is not None
            and tpu.get("merge_flip_estimator", True))
    render = (nn_active and bool(opt.render.rand_sample) and "ray_idx" in var
              and "ray_idx_NN" in var and tpu.get("merge_nn_render", True))
    return bool(enc), bool(flip), bool(render)


def merged_render_draws(draws):
    """`draws` with the sequential renders' draws (`render`, the query's,
    and `render_NN`, one per neighbour view) as the merged render's over
    [query; NN_0; ...]: the same rows re-sliced; the views' eik_idx rows
    feed no eikonal point (zeros)."""
    r, nn_draws = draws.render, draws.render_NN
    out = edict({k: v for k, v in draws.items() if k != "render_NN"})
    out.render = edict(r)
    out.render.t_rand = torch.cat([r.t_rand] + [d.t_rand for d in nn_draws])
    if r.get("eik_idx") is not None:
        out.render.eik_idx = torch.cat(
            [r.eik_idx] + [torch.zeros_like(r.eik_idx)] * len(nn_draws))
    return out


def step_draws(opt, var, draws, generator, nn_active, merge_nn=False):
    """`draws` with every absent draw of a training step taken from
    `generator`: the global batch's tensor (this rank's rows times the world
    size), in the order a one-process step consumes them (the query
    render's jitter and eikonal points, the Gumbel noise, each neighbour
    view's jitter; with `merge_nn` the merged render's jitter over every
    view group and the query's eikonal points, then the Gumbel noise), of
    which this rank keeps its rows."""
    n = var.rgb_input_map.shape[0] * parallel.world_size()
    dev = var.rgb_input_map.device
    V = opt.reg.n_views

    def rays(ray_idx):
        return ray_idx.shape[1] if ray_idx is not None else opt.H * opt.W

    out = edict(draws)
    query_rays = var.get("ray_idx") if opt.render.rand_sample else None
    out.render = renderlib.draw(opt, n, rays(query_rays), True, generator,
                                dev, given=draws.get("render"),
                                groups=1 + V if merge_nn else 1)
    if not nn_active:
        return out
    K = var.rgb_input_map_NN.shape[1]
    if K != V and draws.get("nn_uniform") is None:
        out.nn_uniform = parallel.local_rows(
            1e-20 + (1.0 - 1e-20) * torch.rand(n, K, generator=generator,
                                                device=dev))
    if merge_nn:
        return out
    nn_rays = (var.get("ray_idx_NN")
               if opt.render.rand_sample and "ray_idx_NN" in var else None)
    given = draws.get("render_NN") or [None] * V
    out.render_NN = [
        renderlib.draw(opt, n, rays(None if nn_rays is None
                                    else nn_rays[:, 0]),
                       False, generator, dev, given=given[v])
        for v in range(V)]
    return out


class Graph(nn.Module):
    """Model bundle + the serving forward. `generator` seeds the
    initialisation (the port has no trained weights of its own)."""

    def __init__(self, opt, generator=None):
        super().__init__()
        self.opt = opt
        g = generator
        tpu = opt.get("tpu", {})
        enc_dtype = compute_dtype(tpu.get("encoder_dtype"))
        self.implicit_dtype = tpu.get("implicit_dtype") or "float32"
        compute_dtype(self.implicit_dtype)     # raises on an unknown one
        self.encoder = make_encoder(opt, generator=g, dtype=enc_dtype)
        self.estimator = Estimator.from_opt(opt, generator=g, dtype=enc_dtype)
        self.latent_proj_shape = LatentProjection(
            opt.arch.latent_dim_shape, opt.arch.impl_sdf.proj_latent_dim,
            generator=g)
        self.latent_proj_rgb = LatentProjection(
            opt.arch.latent_dim_rgb, opt.arch.impl_rgb.proj_latent_dim,
            generator=g)
        self.sdf_network = SDFNetwork.from_opt(opt, generator=g)
        self.rgb_network = RGBNetwork.from_opt(opt, generator=g)
        self.density = Density(opt.arch.impl_sdf.beta_init)
        if opt.loss_weight.get("category_reg") is not None:
            self.category_centers = nn.Parameter(0.02 * torch.randn(
                opt.data.num_classes, opt.arch.impl_sdf.proj_latent_dim,
                generator=g))
        self.bn_replicas = self.resolve_bn_replicas(opt)
        W = parallel.world_size()
        if self.bn_replicas == 1:   # the global batch's moments
            set_bn_mode(self, sync=parallel.is_initialized())
        elif self.bn_replicas % W:
            raise ValueError(f"tpu.bn_replicas={self.bn_replicas} does not "
                             f"divide over {W} ranks")
        else:
            set_bn_mode(self, replicas=self.bn_replicas // W)

    @staticmethod
    def resolve_bn_replicas(opt):
        """The per-replica BatchNorm block count over the global batch
        (`graph.py::_resolve_bn_replicas` of the JAX package): 1 unless
        `tpu.bn_mode: per_replica`, then `tpu.bn_replicas`, else the world
        size. Each rank takes `bn_replicas / W` blocks of its rows."""
        tpu = opt.get("tpu", {})
        if tpu.get("bn_mode", "global") != "per_replica":
            return 1
        return int(tpu.get("bn_replicas") or parallel.world_size())

    def load_pretrained_encoders(self):
        """ImageNet-pretrained initialisation from converted .npz files, as
        the JAX package's `Graph._load_pretrained_encoders`: the encoder
        from `arch.enc_weights` or `weights/{arch.enc_network}.npz` when
        `arch.enc_pretrained` is set, the estimator's ResNet18 from
        `arch.est_weights` or `weights/resnet18.npz` always; `fc.*` is
        skipped. A missing file leaves the seeded initialisation and
        warns."""
        arch = self.opt.arch
        jobs = []
        if arch.get("enc_pretrained"):
            jobs.append(("encoder", self.encoder,
                         arch.get("enc_weights")
                         or f"weights/{arch.enc_network}.npz"))
        jobs.append(("estimator", self.estimator.feature_extractor,
                     arch.get("est_weights") or "weights/resnet18.npz"))
        for top, module, path in jobs:
            if not os.path.isfile(path):
                log.warn(f"pretrained weights {path} missing — {top} trains "
                         f"from scratch (convert weights with "
                         f"scripts/convert_weights.py; see RUNBOOK.md)")
                continue
            load_pretrained_npz(module, path, skip_fc=True)
            log.info(f"loaded pretrained {top} weights from {path}")

    def with_opt(self, opt):
        """A Graph that shares every parameter and buffer with this one but
        reads `opt` (the eval render resolution)."""
        view = copy.copy(self)
        view.opt = opt
        return view

    @span("graph.encode")
    def encode(self, images):
        """Image -> (proj_latent_sdf, proj_latent_rgb, latent_raw)."""
        latent_raw = self.encoder(images)
        d = self.opt.arch.latent_dim_shape
        return (self.latent_proj_shape(latent_raw[:, :d]),
                self.latent_proj_rgb(latent_raw[:, d:]), latent_raw)

    @span("graph.pose")
    def pred_pose(self, images):
        """Estimator -> (pose [B,3,4], intr [B,3,3], EstimatorOutputs)."""
        est = self.estimator(images)
        pose, intr = pose_from_trig(self.opt, est.trig_azim, est.trig_elev,
                                    est.trig_theta, est.scale_focal,
                                    est.scale_dist)
        return pose, intr, est

    def render(self, pose, intr, scale_dist, proj_sdf, proj_rgb,
               ray_idx=None, training=False, compute_eikonal=None,
               draws=None, eikonal_batch=None):
        return renderlib.render(self.opt, self.sdf_network, self.rgb_network,
                                self.density.beta, pose, intr, scale_dist,
                                proj_sdf, proj_rgb, ray_idx=ray_idx,
                                training=training,
                                compute_eikonal=compute_eikonal, draws=draws,
                                implicit_dtype=self.implicit_dtype,
                                eikonal_batch=eikonal_batch)

    def forward(self, var, training=False, get_loss=False, draws=None,
                generator=None, render=True):
        """`var` is an EasyDict batch with `rgb_input_map` [B, H, W, 3];
        returns it with the reconstruction fields added, and with
        `get_loss` (training only) `(var, loss)`. `render=False` (eval
        only) stops after the latents and the pose: the metric path reads
        nothing else."""
        if training:
            return self._forward_train(var, get_loss, draws or edict(),
                                       generator)
        if get_loss:
            raise NotImplementedError("eval losses are not ported")
        if any(m.training for m in self.children()):
            raise RuntimeError("call graph.eval() first: serving uses the "
                               "BatchNorm running statistics")
        opt = self.opt
        var = edict(var)
        self._encode_and_pose(var)
        normal_sup = var.get("normal_gt", var.get("normal_input"))
        if normal_sup is not None:
            var.normal_transformed = camera.transform_normal(normal_sup,
                                                             var.pose)
        if not render:
            return var
        out = self.render(var.pose, var.intr, var.scale_dist,
                          var.proj_latent_sdf, var.proj_latent_rgb)
        self._set_render_outputs(var, out)
        self._set_maps(var)
        if normal_sup is not None:
            # data resolution, not render resolution (reference
            # `model/graph.py:101`)
            var.normal_transformed_map = var.normal_transformed.reshape(
                -1, opt.image_size[0], opt.image_size[1], 3)
        return var

    def _encode_and_pose(self, var, flip=False):
        """Encode and pose the query; with `flip` (tpu.merge_flip_estimator)
        the estimator runs on [query; flipped query] as two BatchNorm groups,
        the flipped one without a running-statistics update, and writes
        var.trig_*_flipped for the cam_sym loss."""
        images = var.rgb_input_map
        proj_sdf, proj_rgb, _ = self.encode(images)
        if flip:
            B = images.shape[0]
            with bn_groups(self.estimator, 2, stats_groups=(0,)):
                pose, intr, est = self.pred_pose(
                    torch.cat([images, images.flip(2)]))
            self._set_flipped(var, est, B)
            pose, intr, est = pose[:B], intr[:B], _rows(est, 0, B)
        else:
            pose, intr, est = self.pred_pose(images)
        self._set_latents_and_pose(var, proj_sdf, proj_rgb, pose, intr, est)

    @staticmethod
    def _set_latents_and_pose(var, proj_sdf, proj_rgb, pose, intr, est):
        var.proj_latent_sdf, var.proj_latent_rgb = proj_sdf, proj_rgb
        var.pose, var.intr, var.scale_dist = pose, intr, est.scale_dist
        var.trig_azim, var.trig_elev, var.trig_theta = (
            est.trig_azim, est.trig_elev, est.trig_theta)
        var.scale_focal = est.scale_focal

    @staticmethod
    def _set_flipped(var, est, B):
        """The flipped pass's rows B:2B of a grouped estimator call."""
        var.trig_azim_flipped = est.trig_azim[B:2 * B]
        var.trig_elev_flipped = est.trig_elev[B:2 * B]
        var.trig_theta_flipped = est.trig_theta[B:2 * B]

    @staticmethod
    def _set_render_outputs(var, out, rows=slice(None)):
        var.rgb_recon, var.mask_recon = out.rgb[rows], out.mask[rows]
        var.mask_hard, var.depth_recon = out.mask_hard[rows], out.depth[rows]
        var.normal_recon, var.grad_eikonal = out.normal[rows], out.grad_eikonal

    def _set_maps(self, var):
        opt = self.opt
        B = var.rgb_recon.shape[0]
        var.rgb_recon_map = var.rgb_recon.reshape(B, opt.H, opt.W, 3)
        var.mask_recon_map = var.mask_recon.reshape(B, opt.H, opt.W, 1)
        var.mask_hard_map = var.mask_hard.reshape(B, opt.H, opt.W, 1)
        var.normal_recon_map = var.normal_recon.reshape(B, opt.H, opt.W, 3)

    # --------------------------------------------------------------- training
    def _forward_train(self, var, get_loss, draws, generator):
        """Reference `model/graph.py:68-112`, in the program the merge flags
        pick (`merge_flags`; the JAX package's `Graph.forward`)."""
        opt = self.opt
        var = edict(var)
        ray_idx = var.get("ray_idx") if opt.render.rand_sample else None
        lw = opt.loss_weight
        nn_active = ((lw.get("nearest_img") is not None
                      or lw.get("nearest_mask") is not None)
                     and "rgb_input_map_NN" in var)
        merge_enc, merge_flip, merge_nn = merge_flags(opt, var, nn_active)
        if merge_nn and draws.get("render_NN") is not None:
            draws = merged_render_draws(draws)
        if generator is not None:
            draws = step_draws(opt, var, draws, generator, nn_active,
                               merge_nn)
        prep = None
        if merge_enc:
            prep = self._encode_and_pose_merged(
                var, self._nn_select(var, draws.get("nn_uniform")),
                merge_flip)
        else:
            self._encode_and_pose(var, flip=merge_flip)
        normal_sup = var.get("normal_gt", var.get("normal_input"))
        if normal_sup is not None:
            var.normal_transformed = camera.transform_normal(normal_sup,
                                                             var.pose)
        if merge_nn:
            self._forward_merged(var, draws, ray_idx, prep)
        else:
            out = self.render(var.pose, var.intr, var.scale_dist,
                              var.proj_latent_sdf, var.proj_latent_rgb,
                              ray_idx=ray_idx, training=True,
                              draws=draws.get("render"))
            self._set_render_outputs(var, out)
            if nn_active:
                self.forward_NN(var, draws, prep)
        if not get_loss:
            return var
        return var, self.compute_loss(var)

    def _encode_and_pose_merged(self, var, sels, flip):
        """ONE ResNet34 call over [query; NN_0; ...] (1 + V BatchNorm groups)
        and ONE ResNet18 call over [query; (flipped;) NN_0; ...] (the flip
        group without a running-statistics update), as the JAX package's
        `_encode_and_pose_merged` (tpu.merge_encoders): sets the query's
        latents and pose (and with `flip` var.trig_*_flipped), writes the
        var keys `_nn_prepare` writes and returns its per-view render
        inputs."""
        opt = self.opt
        B = var.rgb_input_map.shape[0]
        V = len(sels)
        d = opt.arch.latent_dim_shape
        with span("graph.encode"):
            with bn_groups(self.encoder, 1 + V):
                latent_all = self.encoder(torch.cat(
                    [var.rgb_input_map] + [s.rgb_input_map for s in sels]))
            # the views project their own RGB latents; the SDF latent is the
            # query's alone
            proj_sdf = self.latent_proj_shape(latent_all[:B, :d])
            with bn_groups(self.latent_proj_rgb, 1 + V):
                proj_rgb_all = self.latent_proj_rgb(latent_all[:, d:])
        f = int(flip)
        G = 1 + f + V
        est_imgs = ([var.rgb_input_map]
                    + ([var.rgb_input_map.flip(2)] if flip else [])
                    + [s.rgb_input_map for s in sels])
        with bn_groups(self.estimator, G,
                       stats_groups=(0,) + tuple(range(1 + f, G))):
            pose_all, intr_all, est_all = self.pred_pose(torch.cat(est_imgs))
        if flip:
            self._set_flipped(var, est_all, B)
        self._set_latents_and_pose(var, proj_sdf, proj_rgb_all[:B],
                                   pose_all[:B], intr_all[:B],
                                   _rows(est_all, 0, B))
        prep = []
        for v in range(V):
            lo, hi = (1 + f + v) * B, (2 + f + v) * B
            prep.append(self._set_view(
                var, v, pose_all[lo:hi], intr_all[lo:hi],
                est_all.scale_dist[lo:hi],
                proj_rgb_all[(1 + v) * B:(2 + v) * B], sels[v]))
        return prep

    @staticmethod
    def _set_view(var, v, pose, intr, scale_dist, proj_rgb, sel):
        """Neighbour view v's var keys -> its render inputs."""
        var[f"proj_latent_rgb_NN_{v}"] = proj_rgb
        # reference parity: holds the LAST view's latent
        var.proj_latent_rgb_NN = proj_rgb
        var[f"pose_NN_{v}"] = pose
        var[f"intr_NN_{v}"] = intr
        var[f"scale_dist_NN_{v}"] = scale_dist
        return dict(pose=pose, intr=intr, scale_dist=scale_dist,
                    proj_rgb=proj_rgb, ray_idx=sel.get("ray_idx"))

    def _forward_merged(self, var, draws, ray_idx, prep=None):
        """ONE render over [query; NN_0; ...] (tpu.merge_nn_render, the JAX
        package's `_forward_merged`): each view's own pose, intrinsics,
        scale, RGB latent and rays, the query's SDF latent for every view,
        the eikonal points of the query rows only; the outputs sliced back
        to the query's keys and `*_recon_NN_v`."""
        if prep is None:
            prep = self._nn_prepare(var, draws)
        B = var.pose.shape[0]

        def cat(query, key):
            return torch.cat([query] + [p[key] for p in prep])

        out = self.render(
            cat(var.pose, "pose"), cat(var.intr, "intr"),
            cat(var.scale_dist, "scale_dist"),
            torch.cat([var.proj_latent_sdf] * (1 + len(prep))),
            cat(var.proj_latent_rgb, "proj_rgb"),
            ray_idx=cat(ray_idx, "ray_idx"), training=True,
            draws=draws.get("render"), eikonal_batch=B)
        self._set_render_outputs(var, out, slice(0, B))
        for v in range(len(prep)):
            rows = slice((1 + v) * B, (2 + v) * B)
            var[f"rgb_recon_NN_{v}"] = out.rgb[rows]
            var[f"mask_recon_NN_{v}"] = out.mask[rows]
            var[f"depth_recon_NN_{v}"] = out.depth[rows]
            var[f"normal_recon_NN_{v}"] = out.normal[rows]

    def _nn_select(self, var, uniform=None):
        """IoU-weighted neighbour selection (reference
        `model/graph.py:119-142`): stores idx_NN and input_NN_v in var and
        returns the per-view inputs. With K == V (the loader pre-selected
        the views, `data.preselect_NN`) the views are taken in order;
        otherwise Gumbel top-k on the scores with the uniform noise
        `uniform` [B, K] in [1e-20, 1) (`step_draws`)."""
        opt = self.opt
        K = var.rgb_input_map_NN.shape[1]
        V = opt.reg.n_views
        assert V <= K
        B = var.rgb_input_map.shape[0]
        dev = var.rgb_input_map.device
        if K == V:
            idx_NN = torch.arange(V, device=dev)[None].expand(B, V)
        else:
            cur_masks = var.mask_input_NN.reshape(B, K, -1).detach()
            inp_mask = var.mask_input.reshape(B, 1, -1).detach()
            inter = (cur_masks * inp_mask).sum(dim=-1)
            union = (cur_masks + inp_mask - cur_masks * inp_mask
                     + 1e-8).sum(dim=-1)
            scores = (1.0 - inter / union) ** opt.reg.sample_temp   # [B,K]
            var.nn_scores = scores
            if uniform is None:
                raise ValueError("neighbour selection needs the draw "
                                 "`nn_uniform`")
            logp = torch.log(torch.clamp(scores, min=1e-20))
            gumbel = -torch.log(-torch.log(uniform))
            idx_NN = torch.topk(logp + gumbel, V, dim=1).indices    # [B,V]
        var.idx_NN = idx_NN
        rows = torch.arange(B, device=dev)
        sels = []
        for v in range(V):
            sel = edict()
            for key in ("rgb_input_map", "mask_input_map", "normal_input_map",
                        "rgb_input", "mask_input", "normal_input"):
                sel[key] = var[f"{key}_NN"][rows, idx_NN[:, v]]
            if opt.render.rand_sample and "ray_idx_NN" in var:
                sel.ray_idx = var.ray_idx_NN[rows, idx_NN[:, v]]
            if "pose_gt_NN" in var:
                sel.pose_gt = var.pose_gt_NN[rows, idx_NN[:, v]]
            var[f"input_NN_{v}"] = sel
            sels.append(sel)
        return sels

    def _nn_prepare(self, var, draws):
        """Neighbour selection + per-view encode and pose (reference
        `model/graph.py:114-205`), in view order after the query's, so the
        BatchNorm running statistics update as the JAX package's
        sequential path composes them."""
        opt = self.opt
        sels = self._nn_select(var, draws.get("nn_uniform"))
        prep = []
        for v, sel in enumerate(sels):
            # the NN view's own RGB latent; the SDF latent stays the query's
            latent_NN = self.encoder(sel.rgb_input_map)
            proj_rgb_NN = self.latent_proj_rgb(
                latent_NN[:, opt.arch.latent_dim_shape:])
            pose_NN, intr_NN, est_NN = self.pred_pose(sel.rgb_input_map)
            prep.append(self._set_view(var, v, pose_NN, intr_NN,
                                       est_NN.scale_dist, proj_rgb_NN, sel))
        return prep

    def forward_NN(self, var, draws, prep=None):
        """CLIP nearest-neighbour consistency branch, one render per view
        with the query's SDF latent (reference `model/graph.py:114-218`);
        `prep`: the views' render inputs when the merged encoders made
        them."""
        if prep is None:
            prep = self._nn_prepare(var, draws)
        render_draws = draws.get("render_NN") or [None] * len(prep)
        for v, p in enumerate(prep):
            # the NN views' eikonal gradients feed no loss
            out = self.render(p["pose"], p["intr"], p["scale_dist"],
                              var.proj_latent_sdf, p["proj_rgb"],
                              ray_idx=p["ray_idx"], training=True,
                              compute_eikonal=False, draws=render_draws[v])
            var[f"rgb_recon_NN_{v}"] = out.rgb
            var[f"mask_recon_NN_{v}"] = out.mask
            var[f"depth_recon_NN_{v}"] = out.depth
            var[f"normal_recon_NN_{v}"] = out.normal

    def compute_loss(self, var):
        """Training losses gated by opt.loss_weight.* (reference
        `model/graph.py:220-265`)."""
        opt = self.opt
        lw = opt.loss_weight
        loss = edict()
        B = var.rgb_recon.shape[0]
        cat_w = var.get("category_weight")
        w3 = cat_w.reshape(B, 1, 1) if cat_w is not None else None
        if lw.get("render") is not None:
            target = var.get("rgb_gt", var.get("rgb_input"))
            loss.render = L.mse_loss(var.rgb_recon, target, weight=w3)
        if lw.get("mask") is not None:
            target = var.get("mask_gt", var.get("mask_input"))
            loss.mask = L.mask_loss(var.mask_recon, target,
                                    mask_mse=opt.reg.mask_mse, weight=w3)
        if lw.get("normal") is not None:
            mask_sup = var.get("mask_gt", var.get("mask_input")) > 0.5
            mask_pred = var.mask_recon > 0.5
            loss.normal = L.normal_loss(
                var.normal_recon, var.normal_transformed,
                mask_sup & mask_pred, normal_l1=opt.reg.normal_l1,
                weight=w3, tolerance=opt.reg.normal_tol)
        if lw.get("eikonal") is not None:
            loss.eikonal = L.mse_loss(
                var.grad_eikonal.reshape(B, -1), 1.0,
                weight=cat_w.reshape(B, 1) if cat_w is not None else None)
        if lw.get("cam_margin") is not None:
            loss.cam_margin = L.cam_margin_loss(opt, var.trig_elev,
                                                var.trig_theta)
        if lw.get("cam_uniform") is not None:
            loss.cam_uniform = L.cam_uniform_loss(var.trig_azim,
                                                  emd_p=opt.reg.emd_p)
        if lw.get("cam_sym") is not None:
            if "trig_azim_flipped" in var:   # the merged flip pass
                trig_f = (var.trig_azim_flipped, var.trig_elev_flipped,
                          var.trig_theta_flipped)
            else:
                # the estimator on the horizontally flipped batch, with batch
                # statistics in train mode; its running-stat update is
                # dropped (reference `model/loss.py:114`)
                with batch_stats_frozen(self.estimator):
                    est_f = self.estimator(var.rgb_input_map.flip(2))
                trig_f = (est_f.trig_azim, est_f.trig_elev, est_f.trig_theta)
            loss.cam_sym = L.cam_sym_loss(
                (var.trig_azim, var.trig_elev, var.trig_theta), trig_f)
        if lw.get("category_reg") is not None:
            loss.category_reg = L.category_reg_loss(
                var.proj_latent_sdf, self.category_centers,
                var.category_label)
        if lw.get("nearest_img") is not None and "rgb_recon_NN_0" in var:
            loss.nearest_img = sum(
                L.mse_loss(var[f"rgb_recon_NN_{v}"],
                           var[f"input_NN_{v}"].rgb_input, weight=w3)
                for v in range(opt.reg.n_views))
        if lw.get("nearest_mask") is not None and "mask_recon_NN_0" in var:
            loss.nearest_mask = sum(
                L.mask_loss(var[f"mask_recon_NN_{v}"],
                            var[f"input_NN_{v}"].mask_input,
                            mask_mse=opt.reg.mask_mse, weight=w3)
                for v in range(opt.reg.n_views))
        if (lw.get("nearest_normal") is not None
                and "normal_recon_NN_0" in var):
            total = 0.0
            for v in range(opt.reg.n_views):
                sel = var[f"input_NN_{v}"]
                mask_sup = sel.mask_input > 0.5
                mask_pred = var[f"mask_recon_NN_{v}"] > 0.5
                total = total + L.normal_loss(
                    var[f"normal_recon_NN_{v}"],
                    camera.transform_normal(sel.normal_input,
                                            var[f"pose_NN_{v}"]),
                    mask_sup & mask_pred, normal_l1=opt.reg.normal_l1,
                    weight=w3, tolerance=opt.reg.normal_tol)
            loss.nearest_normal = total
        return loss

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
        with span("sync.const"):
            t = torch.tensor([0.0, 0.0, float(opt.camera.dist)], device=dev)
        pose_cam = camera.pose(t=t)
        return camera.compose([pose, pose_cam.expand(pose.shape)])


def summarize_loss(opt, loss, non_act_loss_keys=()):
    """Weighted sum of the loss terms into `loss.all`; the keys in
    `non_act_loss_keys` are computed and kept but left out of the sum
    (reference `model/runner.py:294-305`). `loss.finite` is a bool tensor:
    every weighted term finite."""
    loss = edict(loss)
    assert "all" not in loss
    loss_all = 0.0
    finite = None
    for key in list(loss.keys()):
        assert key in opt.loss_weight, key
        if opt.loss_weight[key] is not None:
            term = loss[key].mean()
            ok = torch.isfinite(term)
            finite = ok if finite is None else finite & ok
            if key not in non_act_loss_keys:
                loss_all = loss_all + float(opt.loss_weight[key]) * term
    loss.all = loss_all
    loss.finite = finite if finite is not None else torch.tensor(True)
    return loss
