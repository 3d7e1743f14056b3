"""Runner, serving subset (counterpart of
`shapeclipper_tpu/train/trainer.py`: `build_networks`, `restore_checkpoint`,
`_eval_forward_and_grid` and `vis_rotate`). Training, evaluation and the
optimizers come with later slices.

Everything runs on one explicit `device`. On CUDA every SDF evaluation goes
through the fused Hopper kernel; there is no CPU fallback.
"""

from __future__ import annotations

import os

import torch

from ..eval3d import metrics as eval_3D
from ..models.graph import Graph
from ..utils import checkpoint as ckpt
from ..utils.log import log


class Runner:
    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda but torch.cuda.is_available() is "
                               "False")
        os.makedirs(opt.output_path, exist_ok=True)

    def build_networks(self, opt):
        """Graph at the training resolution + a view of it at
        eval.image_size; weights from a generator seeded with opt.seed."""
        log.info("building networks...")
        generator = torch.Generator().manual_seed(opt.seed or 0)
        self.graph = Graph(opt, generator=generator).to(self.device).eval()
        opt_eval = opt.deepcopy()
        opt_eval.H, opt_eval.W = opt.eval.image_size
        self.graph_eval = self.graph.with_opt(opt_eval)

    def restore_checkpoint(self, opt, best=False):
        """`--resume`: the run's best.pt (or latest.pt); `--load=FILE`: that
        file; neither: keep the seeded initialisation."""
        if opt.resume:
            log.info("resuming from previous checkpoint...")
            ckpt.restore_checkpoint(opt.output_path, self.graph, resume=True,
                                    best=best)
        elif opt.get("load"):
            log.info(f"loading weights from checkpoint {opt.load}...")
            ckpt.restore_checkpoint(opt.output_path, self.graph,
                                    load_name=opt.load)
        else:
            log.info("initializing weights from scratch...")

    @torch.inference_mode()
    def eval_forward_and_grid(self, var):
        """Forward (encoder, estimator, eval render) + the dense SDF grid
        -> (var, level [B, vox+1, vox+1, vox+1])."""
        var = self.graph_eval(var)
        level = eval_3D.compute_level_grid(self.graph_eval.opt,
                                           self.graph.sdf_network,
                                           var.proj_latent_sdf)
        return var, level

    @torch.inference_mode()
    def vis_rotate(self, opt, var, n_views=50):
        """Rotating-azimuth views at eval.image_size -> var with
        rotating_imgs / rotating_masks / rotating_normals (lists of
        [B, H, W, C] numpy frames)."""
        opt_e = self.graph_eval.opt
        vis_pose = self.graph.get_rotate_pose(n_views=n_views)
        B = var.proj_latent_sdf.shape[0]
        H, W = opt_e.H, opt_e.W
        imgs, masks, normals = [], [], []
        for i in range(n_views):
            pose_i = vis_pose[i][None].expand(B, 3, 4)
            out = self.graph_eval.render(pose_i, var.intr,
                                         torch.ones_like(var.scale_dist),
                                         var.proj_latent_sdf,
                                         var.proj_latent_rgb)
            imgs.append(out.rgb.reshape(B, H, W, 3).cpu().numpy())
            masks.append(out.mask.reshape(B, H, W, 1).cpu().numpy())
            normals.append(out.normal.reshape(B, H, W, 3).cpu().numpy() / 2
                           + 0.5)
        var.rotating_imgs = imgs
        var.rotating_masks = masks
        var.rotating_normals = normals
        return var
