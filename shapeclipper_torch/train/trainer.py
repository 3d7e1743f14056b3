"""Runner (counterpart of `shapeclipper_tpu/train/trainer.py`): data,
networks, the two Adam optimizers, checkpoints, one training iteration
(`train_iteration`), and the serving entry points `eval_forward_and_grid`
and `vis_rotate`. The epoch loop (`train`, `train_epoch`, `evaluate`) and
the TensorBoard logging come with the evaluate slice.

Everything runs on one explicit `device`. On CUDA every SDF evaluation goes
through the fused Hopper kernels (K1 / K3 forward, K2 backward); there is no
CPU fallback.
"""

from __future__ import annotations

import importlib
import math
import os

import numpy as np
import torch

from ..eval3d import metrics as eval_3D
from ..models.graph import Graph, summarize_loss
from ..utils import checkpoint as ckpt
from ..utils.easydict import EasyDict as edict
from ..utils.log import Timer, log
from .. import vis as util_vis
from .pretrainer import make_optimizer

# losses computed but left out of loss.all in the camera phase
CAMERA_PHASE_INACTIVE = ("nearest_img", "nearest_mask", "nearest_normal",
                         "eikonal")

# configuration the JAX package reads that the port does not
_IGNORED_TPU_KEYS = ("merge_nn_render", "merge_flip_estimator",
                     "merge_encoders", "sdf_grad_mode", "fold_eikonal",
                     "remat_renderer", "encoder_dtype", "implicit_dtype")


def batch_to_var(batch, device):
    """A collated numpy batch -> EasyDict of tensors on `device`."""
    return edict({k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in batch.items()})


class Runner:
    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda but torch.cuda.is_available() is "
                               "False")
        os.makedirs(opt.output_path, exist_ok=True)
        self.viz_data = []
        self.timer = Timer()

    # ------------------------------------------------------------------ data
    def load_dataset(self, opt, eval_split="val"):
        data = importlib.import_module(
            f"shapeclipper_torch.data.{opt.data.dataset}")
        log.info("loading training data...")
        self.train_data = data.Dataset(opt, split="train")
        self.train_loader = self.train_data.setup_loader(
            opt, shuffle=True, seed=opt.seed or 0, batch_size=opt.batch_size)
        self.num_batches = len(self.train_loader)
        log.info("loading test data...")
        self.test_data = data.Dataset(opt, split=eval_split)
        self.test_loader = self.test_data.setup_loader(
            opt, shuffle=False, drop_last=False,
            batch_size=opt.eval.batch_size)
        log.info("creating data for visualization...")
        self.viz_data = self._collect_viz_data(opt)

    def _collect_viz_data(self, opt):
        """One sample per category, up to eval.n_vis_classes, repeated
        eval.n_vis times (reference `runner.py:60-89`)."""
        n_vis_classes = min(opt.eval.get("n_vis_classes", opt.data.num_classes),
                            opt.data.num_classes)
        viz_loader = self.test_data.setup_loader(
            opt, shuffle=True, drop_last=False,
            batch_size=opt.eval.batch_size, seed=1234)
        n_vis = opt.eval.n_vis
        rounds = [[0] * opt.data.num_classes for _ in range(n_vis)]
        picks = [[] for _ in range(n_vis)]
        for batch in viz_loader:
            for i, cat in enumerate(np.asarray(batch["category_label"])):
                for r in range(n_vis):  # first round missing this category
                    if (rounds[r][int(cat)] < 1
                            and sum(rounds[r]) < n_vis_classes):
                        rounds[r][int(cat)] += 1
                        picks[r].append({k: v[i:i + 1]
                                         for k, v in batch.items()})
                        break
            if all(sum(r) >= n_vis_classes for r in rounds):
                break
        return [sample for r in picks for sample in r]

    def build_networks(self, opt):
        """Graph at the training resolution + a view of it at
        eval.image_size; weights from a generator seeded with opt.seed."""
        log.info("building networks...")
        generator = torch.Generator().manual_seed(opt.seed or 0)
        self.graph = Graph(opt, generator=generator).to(self.device).eval()
        opt_eval = opt.deepcopy()
        opt_eval.H, opt_eval.W = opt.eval.image_size
        self.graph_eval = self.graph.with_opt(opt_eval)
        # the step's random draws (JAX: PRNGKey(seed + 7))
        self.generator = torch.Generator(self.device).manual_seed(
            (opt.seed or 0) + 7)
        ignored = [k for k in _IGNORED_TPU_KEYS if k in opt.get("tpu", {})]
        log.info(f"the port ignores tpu.{{{', '.join(ignored)}}}: float32, "
                 "sequential encoders and renders, every CUDA SDF "
                 "evaluation through the fused kernels (K1 + K2)")

    # ------------------------------------------------------------ optimizer
    def setup_optimizer(self, opt):
        """optim_full over every parameter; optim_V over the estimator's
        (the camera phase)."""
        log.info("setting up optimizers...")
        self.optim_full = make_optimizer(opt, self.graph.parameters())
        self.optim_V = make_optimizer(opt, self.graph.estimator.parameters())

    # ------------------------------------------------------------ checkpoint
    def restore_checkpoint(self, opt, best=False):
        """`--resume`: the run's best.pt (or latest.pt, or checkpoint/epN.pt
        for resume=N) with the optimizer states; `--load=FILE`: that file's
        weights; neither: keep the seeded initialisation."""
        epoch_start = iter_start = None
        self.best_val = math.inf
        if opt.resume:
            log.info("resuming from previous checkpoint...")
            optimizers = {name: getattr(self, name)
                          for name in ("optim_full", "optim_V")
                          if hasattr(self, name)}
            epoch_start, iter_start, self.best_val = ckpt.restore_checkpoint(
                opt.output_path, self.graph, optimizers, resume=opt.resume,
                best=best)
        elif opt.get("load"):
            log.info(f"loading weights from checkpoint {opt.load}...")
            ckpt.restore_checkpoint(opt.output_path, self.graph,
                                    load_name=opt.load)
        else:
            log.info("initializing weights from scratch...")
        self.epoch_start = epoch_start or 0
        self.iter_start = iter_start or 0
        self.ep, self.it = self.epoch_start, self.iter_start

    def save_checkpoint(self, opt, ep=0, it=0, best_val=math.inf,
                        latest=False, best=False):
        ckpt.save_checkpoint(
            opt.output_path, self.graph.state_dict(),
            optim_states={"optim_full": self.optim_full.state_dict(),
                          "optim_V": self.optim_V.state_dict()},
            ep=ep, it=it, best_val=best_val, latest=latest, best=best)
        if not latest:
            log.info(f"checkpoint saved: ({opt.group}) {opt.name}, "
                     f"epoch {ep} (iteration {it})")
        if best:
            log.info("Saving the current model as the best...")

    # ----------------------------------------------------------------- train
    def train_iteration(self, opt, var, draws=None):
        """One optimizer step on the batch `var` (tensors on the device).
        `draws` (see `Graph.forward`) fixes the step's random draws; absent
        ones come from `self.generator`.

        Iteration `it <= optim.iter_camera` (so always iteration 0) is a
        camera step: BatchNorm runs on its running statistics and does not
        update them, the losses CAMERA_PHASE_INACTIVE stay out of loss.all,
        and optim_V updates the estimator only. Otherwise a full step:
        train-mode BatchNorm and optim_full over every parameter. Returns
        the step's loss terms (detached)."""
        self.timer.begin_iter()
        camera_phase = self.it <= opt.optim.iter_camera
        optimizer = self.optim_V if camera_phase else self.optim_full
        self.graph.train(not camera_phase)
        # gradients never carry over, so a camera step's gradients on the
        # parameters it does not update never reach optim_full
        self.graph.zero_grad(set_to_none=True)
        _, loss = self.graph(var, training=True, get_loss=True, draws=draws,
                             generator=self.generator)
        loss = summarize_loss(opt, loss, non_act_loss_keys=(
            CAMERA_PHASE_INACTIVE if camera_phase else ()))
        loss.all.backward()
        for group in optimizer.param_groups:
            for p in group["params"]:
                # optax updates every parameter, zero gradient or not
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        loss = edict({k: v.detach() if torch.is_tensor(v) else v
                      for k, v in loss.items()})

        # one-step-delayed finite check: reading this step's flag would
        # synchronise with the device every step
        pending = getattr(self, "_pending_loss", None)
        if pending is not None and not bool(pending[1].finite):
            terms = {k: float(v.mean()) for k, v in pending[1].items()
                     if k != "finite"}
            raise AssertionError(f"non-finite loss at iter {pending[0]}: "
                                 f"{terms}")
        self._pending_loss = (self.it, loss)

        if (self.it + 1) % opt.freq.ckpt_latest == 0:
            self.save_checkpoint(opt, ep=self.ep, it=self.it + 1,
                                 best_val=self.best_val, latest=True)
        if self.it % opt.freq.save_vis == 0:
            self.save_vis_dumps(opt, folder=f"vis_log/iter_{self.it}")
        self.it += 1
        self.timer.end_iter(opt.max_epoch, self.ep,
                            getattr(self, "num_batches", 1))
        return loss

    def save_vis_dumps(self, opt, folder):
        """Eval-resolution renders of the visualization samples as PNGs."""
        if not self.viz_data:
            return
        os.makedirs(f"{opt.output_path}/{folder}", exist_ok=True)
        was_training = self.graph.training
        self.graph.eval()
        for batch in self.viz_data:
            with torch.inference_mode():
                var = self.graph_eval(batch_to_var(batch, self.device))
            var = edict({k: v.cpu().numpy() for k, v in var.items()
                         if torch.is_tensor(v)})
            util_vis.dump_images(opt, var.idx, "image_input",
                                 var.rgb_input_map, folder=folder)
            util_vis.dump_images(opt, var.idx, "image_recon",
                                 var.rgb_recon_map, masks=var.mask_hard_map,
                                 poses=var.pose, folder=folder)
            util_vis.dump_images(opt, var.idx, "mask_recon",
                                 var.mask_recon_map, folder=folder)
            util_vis.dump_images(opt, var.idx, "mask_input",
                                 var.mask_input_map, folder=folder)
            util_vis.dump_images(opt, var.idx, "normal_recon",
                                 var.normal_recon_map, from_range=(-1, 1),
                                 folder=folder)
        self.graph.train(was_training)

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
