"""Runner (counterpart of `shapeclipper_tpu/train/trainer.py`): data,
networks, the two Adam optimizers, checkpoints, the epoch loop (`train`,
`train_epoch`, `train_iteration` with its TensorBoard and dump hooks), the
pipelined evaluation (`evaluate`: Chamfer-L1 and F-score reports, dumps,
rotating views), and the serving entry points `eval_forward_and_grid` and
`vis_rotate`.

Everything runs on one explicit `device`. On CUDA every SDF evaluation goes
through the fused Hopper kernels (K1 / K3 forward, K2 backward) and every
nearest-neighbour sweep of the metrics through K4; there is no CPU
fallback.

Under a process group (`parallel`, one process per rank) the Runner is data
parallel: rank r loads its share of every global batch, `TrainStep` runs
under `DistributedDataParallel`, the logged losses are the global batch's,
and an evaluation splits the test batches over the ranks and gathers
their per-sample metrics, so that every rank takes the same best epoch.
Rank 0 alone cleans the output folder and writes checkpoints, TensorBoard
events, the training dumps and the evaluation reports; each rank dumps
its own evaluated samples; every rank restores.

Profiler ranges (`utils/trace.py`, recorded only while a profiler runs):
a step's `sc.step.batch` (`batch_to_var`, a `sc.sync.batch` a copy),
`sc.step.forward`, `sc.step.backward`, `sc.step.optimizer` (the zero-fill
and the optimizer's step) and `sc.sync.finite` (the delayed finite check)
are read in the
Chrome trace of the operator's `tpu.profile_iters` window
(`_profile_window`); the turntable's `sc.vis.rotate`, `sc.vis.view` and
`sc.sync.view` (its three host copies a view) are read by the benchmark's
request cell (`benchmark/metrics/`); `build_networks` is
`timed("setup.networks")`.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import os
import shutil

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from .. import parallel
from ..eval3d import metrics as eval_3D
from ..models.estimator import reset_scale_params
from ..models.graph import Graph, summarize_loss
from ..ops.fused_sdf import arch_from_opt, route_note
from ..utils import checkpoint as ckpt
from ..utils.easydict import EasyDict as edict
from ..utils.log import Timer, log
from ..utils import trace
from .. import vis as util_vis
from .pretrainer import make_optimizer

# losses computed but left out of loss.all in the camera phase
CAMERA_PHASE_INACTIVE = ("nearest_img", "nearest_mask", "nearest_normal",
                         "eikonal")

# var keys (small tensors) of a training step's forward that the logging
# hooks read, beside the batch
_STEP_AUX_KEYS = ("proj_latent_sdf", "proj_latent_rgb", "pose", "scale_dist",
                  "trig_azim", "trig_elev", "trig_theta", "scale_focal")

# the `tpu:` configuration the port honours (tpu.bn_mode, tpu.bn_replicas,
# tpu.encoder_dtype, tpu.implicit_dtype, tpu.merge_*: models/graph.py;
# tpu.mesh: parallel.check_mesh; tpu.profile_iters: Runner.train_iteration;
# tpu.device_isosurface: eval3d/metrics.py; tpu.eval_pipeline:
# Runner.evaluate), and what else the JAX package reads, which the port
# ignores and names in its log
HONOURED_TPU_KEYS = ("mesh", "bn_mode", "bn_replicas", "encoder_dtype",
                     "implicit_dtype", "merge_nn_render",
                     "merge_flip_estimator", "merge_encoders",
                     "profile_iters", "device_isosurface", "eval_pipeline")
IGNORED_TPU_KEYS = ("sdf_grad_mode", "fold_eikonal", "remat_renderer",
                    "fused_eval", "donate_state")


def tpu_keys_note(opt):
    """The log line on the `tpu:` configuration: the keys of `opt.tpu` that
    the port ignores, and what it does instead, with the fused SDF route
    that the configured SDF MLP takes on CUDA (`ops/fused_sdf.py::
    sdf_route`)."""
    tpu = opt.get("tpu", {})
    ignored = [k for k in IGNORED_TPU_KEYS if k in tpu]
    merged = [k for k in ("merge_encoders", "merge_flip_estimator",
                          "merge_nn_render") if tpu.get(k, True)]
    window = tpu.get("profile_iters")
    route = (route_note(arch_from_opt(opt)) if opt.get("arch")
             else "the fused kernels")
    return (f"the port ignores tpu.{{{', '.join(ignored)}}}: every CUDA SDF "
            f"evaluation through fused kernels ({route}), no "
            "donation switch; it honours tpu.{"
            + ", ".join(HONOURED_TPU_KEYS) + "}: encoders in "
            f"{tpu.get('encoder_dtype') or 'float32'}, implicit MLPs in "
            f"{tpu.get('implicit_dtype') or 'float32'}, merged "
            + ("{" + ", ".join(merged) + "}" if merged else "nothing")
            + ", profiler window "
            + (f"iterations {window[0]}-{window[1] - 1}" if window
               else "off")
            + ", surface sampling on the "
            + ("device" if tpu.get("device_isosurface", False) else "host")
            + ", evaluation "
            + ("pipelined" if tpu.get("eval_pipeline", True) else "serial"))


@trace.span("step.batch")
def batch_to_var(batch, device):
    """A collated numpy batch -> EasyDict of tensors on `device`. On CUDA
    each copy from pageable memory waits for the stream: a `sync.batch`
    range each."""
    var = edict()
    for k, v in batch.items():
        with trace.span("sync.batch"):
            var[k] = torch.from_numpy(np.asarray(v)).to(device)
    return var


def to_host(var):
    """An EasyDict of tensors (nested ones too) -> the same with numpy arrays
    on the host; other values are kept."""
    out = edict()
    for k, v in var.items():
        if torch.is_tensor(v):
            out[k] = trace.to_host(v.detach(), "to_host").numpy()
        elif isinstance(v, dict):
            out[k] = to_host(v)
        else:
            out[k] = v
    return out


class TrainStep(nn.Module):
    """A training step's forward as one module, the unit DDP wraps:
    `Graph.forward(training=True)`, its losses and `summarize_loss` ->
    (loss.all, the loss terms detached, the `aux_keys` of the forward's var
    detached). loss.all is the only output that autograd reaches, so DDP's
    search for unused parameters finds exactly those the backward skips
    (the camera phase leaves CAMERA_PHASE_INACTIVE out of loss.all)."""

    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def forward(self, var, non_act_loss_keys=(), aux_keys=(), draws=None,
                generator=None):
        out, loss = self.graph(var, training=True, get_loss=True,
                               draws=draws, generator=generator)
        loss = summarize_loss(self.graph.opt, loss, non_act_loss_keys)
        terms = edict({k: v.detach() if torch.is_tensor(v) else v
                       for k, v in loss.items() if k != "all"})
        aux = edict({k: out[k].detach() for k in aux_keys if k in out})
        return loss.all, terms, aux


class Runner:
    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda but torch.cuda.is_available() is "
                               "False")
        self.tb = None  # set by setup_visualizer
        self.step_model = None  # set by _train_model
        self.profiler = None  # the open tpu.profile_iters window
        if (parallel.is_main() and os.path.isdir(opt.output_path)
                and not opt.get("resume")):
            for filename in os.listdir(opt.output_path):
                if "tfevents" in filename:
                    os.remove(os.path.join(opt.output_path, filename))
                if "vis" in filename:
                    shutil.rmtree(os.path.join(opt.output_path, filename),
                                  ignore_errors=True)
        os.makedirs(opt.output_path, exist_ok=True)
        parallel.barrier()
        self.viz_data = []
        self.timer = Timer()
        self.best_val, self.best_ep = math.inf, None

    # ------------------------------------------------------------------ data
    def load_dataset(self, opt, eval_split="val"):
        data = importlib.import_module(
            f"shapeclipper_torch.data.{opt.data.dataset}")
        log.info("loading training data...")
        self.train_data = data.Dataset(opt, split="train")
        # each rank loads positions rank, rank + W, ... of every global
        # batch (JAX: trainer.py's per-process split; reference
        # DistributedSampler)
        W = parallel.world_size()
        if opt.batch_size % W:
            raise ValueError(f"batch_size {opt.batch_size} does not divide "
                             f"over {W} ranks")
        self.train_loader = self.train_data.setup_loader(
            opt, shuffle=True, seed=opt.seed or 0,
            batch_size=opt.batch_size // W, shard_id=parallel.rank(),
            num_shards=W)
        self.num_batches = len(self.train_loader)
        log.info("loading test data...")
        self.test_data = data.Dataset(opt, split=eval_split)
        # each rank builds test batches rank, rank + W, ... only
        self.test_loader = self.test_data.setup_loader(
            opt, shuffle=False, drop_last=False,
            batch_size=opt.eval.batch_size, batch_shard_id=parallel.rank(),
            num_batch_shards=W)
        log.info("creating data for visualization...")
        # rank 0 alone visualizes
        self.viz_data = self._collect_viz_data(opt) if parallel.is_main() \
            else []

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

    @trace.timed("setup.networks")
    def build_networks(self, opt):
        """Graph at the training resolution + a view of it at
        eval.image_size; weights from a generator seeded with opt.seed, then
        the pretrained encoders where their .npz files exist."""
        log.info("building networks...")
        parallel.check_mesh(opt)
        generator = torch.Generator().manual_seed(opt.seed or 0)
        graph = Graph(opt, generator=generator)
        graph.load_pretrained_encoders()
        self.graph = graph.to(self.device).eval()
        opt_eval = opt.deepcopy()
        opt_eval.H, opt_eval.W = opt.eval.image_size
        self.graph_eval = self.graph.with_opt(opt_eval)
        # the step's random draws (JAX: PRNGKey(seed + 7))
        self.generator = torch.Generator(self.device).manual_seed(
            (opt.seed or 0) + 7)
        log.info(tpu_keys_note(opt))

    # ------------------------------------------------------------ optimizer
    def setup_optimizer(self, opt):
        """optim_full over every parameter; optim_V over the estimator's
        (the camera phase)."""
        log.info("setting up optimizers...")
        self.optim_full = make_optimizer(opt, self.graph.parameters())
        self.optim_V = make_optimizer(opt, self.graph.estimator.parameters())

    # ------------------------------------------------------------ checkpoint
    def restore_checkpoint(self, opt, best=False, evaluate=False):
        """`--resume`: the run's best.pt (or latest.pt, or checkpoint/epN.pt
        for resume=N) with the optimizer states, strictly unless `evaluate`;
        `--load=FILE`: that file's weights, per top-level child; neither:
        keep the seeded initialisation."""
        epoch_start = iter_start = None
        self.best_val = math.inf
        if opt.resume:
            log.info("resuming from previous checkpoint...")
            optimizers = {name: getattr(self, name)
                          for name in ("optim_full", "optim_V")
                          if hasattr(self, name)}
            epoch_start, iter_start, self.best_val = ckpt.restore_checkpoint(
                opt.output_path, self.graph, optimizers, resume=opt.resume,
                best=best, evaluate=evaluate)
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
        """Rank 0 writes; the other ranks return."""
        if not parallel.is_main():
            return
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

    # ------------------------------------------------------------ visualizer
    def setup_visualizer(self, opt):
        """A TensorBoard writer in the run's folder when `opt.tb` is set
        (ImportError without the `tensorboard` package)."""
        log.info("setting up visualizers...")
        self.tb = None
        if opt.get("tb") and parallel.is_main():
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir=opt.output_path, flush_secs=10)

    # ----------------------------------------------------------------- train
    def train(self, opt):
        """Evaluate at epoch 0 (a fresh run), then `max_epoch` epochs, each
        evaluated every `freq.eval` epochs with `best.pt` kept on the
        Chamfer distance; a final `checkpoint/ep{N}.pt`."""
        log.title("TRAINING START")
        reset_scale_params(self.graph.estimator)
        self.timer = Timer()
        self.iter_skip = self.iter_start % max(self.num_batches, 1)
        self.it = self.iter_start
        if not opt.resume:
            self.best_val, self.best_ep = math.inf, 1
        if self.iter_start == 0:
            self.evaluate(opt, ep=0, training=True)
        for self.ep in range(self.epoch_start, opt.max_epoch):
            self.train_epoch(opt)
        self._close_profile_window(opt)
        self.save_checkpoint(opt, ep=self.ep + 1, it=self.it,
                             best_val=self.best_val)
        if self.tb:
            self.tb.flush()
            self.tb.close()
        log.title("TRAINING DONE")
        if parallel.is_main():
            log.info(f"Best CD: {self.best_val:.4f} @ epoch {self.best_ep}")

    def _device_batches(self, loader):
        """The loader's batches as tensors on the device. The first
        `iter_skip` batches (a resumed epoch's finished iterations) are
        loaded and dropped on the host: the resume fast-forward."""
        for batch in loader:
            if self.iter_skip > 0:
                self.iter_skip -= 1
                continue
            yield batch_to_var(batch, self.device)

    def train_epoch(self, opt):
        self.train_loader.set_epoch(self.ep)
        loss = None
        for var in self._device_batches(self.train_loader):
            loss = self.train_iteration(opt, var)
        if loss is not None and parallel.is_main():
            log.loss_train(opt, self.ep + 1, opt.optim.lr, loss["all"],
                           self.timer)
        if (self.ep + 1) % opt.freq.eval == 0:
            current_val = self.evaluate(opt, ep=self.ep + 1, training=True)
            if current_val < self.best_val:
                self.best_val = current_val
                self.best_ep = self.ep + 1
                self.save_checkpoint(opt, ep=self.ep + 1, it=self.it,
                                     best_val=self.best_val, best=True,
                                     latest=True)

    def train_iteration(self, opt, var, draws=None):
        """One optimizer step on the batch `var` (tensors on the device).
        `draws` (see `Graph.forward`) fixes the step's random draws; absent
        ones come from `self.generator`.

        Iteration `it <= optim.iter_camera` (so always iteration 0) is a
        camera step: BatchNorm runs on its running statistics and does not
        update them, the losses CAMERA_PHASE_INACTIVE stay out of loss.all,
        and optim_V updates the estimator only. Otherwise a full step:
        train-mode BatchNorm and optim_full over every parameter. Returns
        the step's loss terms (detached; the global batch's under data
        parallelism, the same on every rank)."""
        self.timer.begin_iter()
        self._profile_window(opt)
        camera_phase = self.it <= opt.optim.iter_camera
        optimizer = self.optim_V if camera_phase else self.optim_full
        self.graph.train(not camera_phase)
        # gradients never carry over, so a camera step's gradients on the
        # parameters it does not update never reach optim_full
        self.graph.zero_grad(set_to_none=True)
        aux_keys = (_STEP_AUX_KEYS + ("idx_NN",)
                    + tuple(f"pose_NN_{v}" for v in range(opt.reg.n_views))
                    + tuple(f"scale_dist_NN_{v}"
                            for v in range(opt.reg.n_views)))
        with trace.span("step.forward"):
            loss_all, loss, aux_var = self._train_model()(
                var, CAMERA_PHASE_INACTIVE if camera_phase else (), aux_keys,
                draws=draws, generator=self.generator)
        # under DDP the backward also averages the gradients over the ranks,
        # before the zero-fill and the step
        with trace.span("step.backward"):
            loss_all.backward()
        with trace.span("step.optimizer"):
            for group in optimizer.param_groups:
                for p in group["params"]:
                    # optax updates every parameter, zero gradient or not
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            optimizer.step()
        loss.all = loss_all.detach()
        loss = self._global_loss(loss)

        # one-step-delayed finite check: reading this step's flag would
        # synchronise with the device every step
        pending = getattr(self, "_pending_loss", None)
        if pending is not None and not bool(
                trace.to_host(pending[1].finite, "finite")):
            terms = {k: float(v.mean()) for k, v in pending[1].items()
                     if k != "finite"}
            raise AssertionError(f"non-finite loss at iter {pending[0]}: "
                                 f"{terms}")
        self._pending_loss = (self.it, loss)

        if self.it % opt.freq.vis == 0 and self.tb:
            # train-split panels from the live batch, with the CLIP-NN input
            # views chosen this step (reference `runner.py:260-261`)
            train_var = edict(var)
            train_var.update(aux_var)
            self.visualize(opt, to_host(train_var), step=self.it,
                           split="train")
        if (self.it + 1) % opt.freq.ckpt_latest == 0:
            self.save_checkpoint(opt, ep=self.ep, it=self.it + 1,
                                 best_val=self.best_val, latest=True)
        if self.it % opt.freq.scalar == 0 and self.tb:
            self.log_scalars(opt, var, aux_var, loss, step=self.it)
        if self.it % opt.freq.save_vis == 0:
            self.save_vis_dumps(opt, folder=f"vis_log/iter_{self.it}")
        self.it += 1
        self.timer.end_iter(opt.max_epoch, self.ep,
                            getattr(self, "num_batches", 1))
        return loss

    def _profile_window(self, opt):
        """`tpu.profile_iters: [a, b]`: torch.profiler (the CPU, and CUDA on
        a card) opens before iteration a and closes before iteration b, on
        rank 0 (the JAX package's `jax.profiler` window,
        `shapeclipper_tpu/train/trainer.py:331-340`)."""
        window = opt.get("tpu", {}).get("profile_iters")
        if not window or not parallel.is_main():
            return
        if self.it == int(window[1]):
            self._close_profile_window(opt)
        if self.it == int(window[0]) and self.profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.start()
            self.profile_window = (self.it, int(window[1]))

    def _close_profile_window(self, opt):
        """Stop an open profiler window and write its Chrome trace to
        `output_path/profile/trace_iters_A-B.json` (iterations A to B - 1,
        or to the last one taken)."""
        if self.profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        first, end = self.profile_window
        folder = os.path.join(opt.output_path, "profile")
        os.makedirs(folder, exist_ok=True)
        last = min(end, self.it) - 1
        path = os.path.join(folder, f"trace_iters_{first}-{last}.json")
        self.profiler.export_chrome_trace(path)
        self.profiler = None
        log.info(f"profiler trace written to {path}")

    def _train_model(self):
        """The TrainStep over the graph; under a process group, of any
        world size, wrapped in DDP (built at the first step, after the
        restores; rank 0's buffers are broadcast before every forward)."""
        if self.step_model is None:
            self.step_model = TrainStep(self.graph)
            if parallel.is_initialized():
                self.step_model = DistributedDataParallel(
                    self.step_model, find_unused_parameters=True)
        return self.step_model

    def _global_loss(self, loss):
        """The loss terms' means over the ranks; `finite` when every rank's
        terms are."""
        if not parallel.is_initialized():
            return loss
        keys = [k for k in loss if k != "finite"]
        dtype = loss.all.dtype
        vals = torch.stack([torch.as_tensor(loss[k], dtype=dtype,
                                            device=self.device).mean()
                            for k in keys] + [(~loss.finite).to(dtype)])
        vals = parallel.mean_over_ranks(vals)
        out = edict(zip(keys, vals[:-1]))
        out.finite = vals[-1] == 0
        return out

    @contextlib.contextmanager
    def _eval_mode(self):
        """BatchNorm on its running statistics and no autograd, for the
        block; the graph's mode is restored after."""
        was_training = self.graph.training
        self.graph.eval()
        try:
            with torch.inference_mode():
                yield
        finally:
            self.graph.train(was_training)

    def save_vis_dumps(self, opt, folder):
        """Eval-resolution renders of the visualization samples as PNGs
        (rank 0)."""
        if not self.viz_data or not parallel.is_main():
            return
        os.makedirs(f"{opt.output_path}/{folder}", exist_ok=True)
        with self._eval_mode():
            for batch in self.viz_data:
                var = to_host(self.graph_eval(batch_to_var(batch,
                                                           self.device)))
                util_vis.dump_images(opt, var.idx, "image_input",
                                     var.rgb_input_map, folder=folder)
                util_vis.dump_images(opt, var.idx, "image_recon",
                                     var.rgb_recon_map,
                                     masks=var.mask_hard_map, poses=var.pose,
                                     folder=folder)
                util_vis.dump_images(opt, var.idx, "mask_recon",
                                     var.mask_recon_map, folder=folder)
                util_vis.dump_images(opt, var.idx, "mask_input",
                                     var.mask_input_map, folder=folder)
                util_vis.dump_images(opt, var.idx, "normal_recon",
                                     var.normal_recon_map,
                                     from_range=(-1, 1), folder=folder)

    # -------------------------------------------------------------- logging
    def log_scalars(self, opt, var, aux_var, loss, step=0, split="train"):
        """Loss terms, beta and (train split) the batch's Chamfer distances
        to TensorBoard."""
        for key, value in loss.items():
            if key in ("all", "finite"):
                continue
            self.tb.add_scalar(f"{split}/loss_{key}", float(value.mean()),
                               step)
        self.tb.add_scalar(f"{split}/loss_all", float(loss["all"]), step)
        self.tb.add_scalar("train/beta",
                           float(self.graph.density.beta.detach().abs()),
                           step)
        if split == "train" and "dpc_points" in var:
            mvar = edict(proj_latent_sdf=aux_var.proj_latent_sdf,
                         pose=aux_var.pose, pose_gt=var.pose_gt,
                         dpc_points=var.dpc_points)
            try:
                with torch.inference_mode():
                    dist_acc, dist_cov = eval_3D.eval_metrics(
                        opt, mvar, self.graph.sdf_network,
                        rng=np.random.RandomState(step), seed=step,
                        need_meshes=False)
                self.tb.add_scalar(f"{split}/dist_acc", dist_acc, step)
                self.tb.add_scalar(f"{split}/dist_cov", dist_cov, step)
            except Exception as e:  # metric eval must never kill training
                log.warn(f"train-split metric eval failed: {e}")

    def visualize_viz_data(self, opt, step=0, split="train"):
        opt_e = self.graph_eval.opt
        with self._eval_mode():
            for batch in self.viz_data:
                var = self.graph_eval(batch_to_var(batch, self.device))
                self.visualize(opt_e, to_host(var), step=step, split=split)

    def visualize(self, opt, var, step=0, split="train"):
        """TensorBoard image panels of a host (numpy) var."""
        if not self.tb:
            return
        util_vis.tb_image(opt, self.tb, step, split, "image_input_map",
                          var.rgb_input_map, from_range=(0, 1),
                          poses=var.get("pose_gt"))
        util_vis.tb_image(opt, self.tb, step, split, "mask_input_map",
                          var.mask_input_map)
        if "rgb_recon_map" in var:
            util_vis.tb_image(opt, self.tb, step, split, "image_recon_map",
                              var.rgb_recon_map, from_range=(0, 1),
                              poses=var.get("pose"))
            util_vis.tb_image(opt, self.tb, step, split, "mask_recon_map",
                              var.mask_recon_map)
        if "normal_recon_map" in var:
            util_vis.tb_image(opt, self.tb, step, split, "normal_recon_map",
                              var.normal_recon_map, from_range=(-1, 1))
        if "normal_input_map" in var:
            util_vis.tb_image(opt, self.tb, step, split,
                              "normal_input_viewpoint_map",
                              var.normal_input_map, from_range=(-1, 1))
        if "normal_transformed_map" in var:
            util_vis.tb_image(opt, self.tb, step, split,
                              "normal_input_canonical_map",
                              var.normal_transformed_map, from_range=(-1, 1))
        # CLIP-NN view panels (reference `model/runner.py:449-459`): the
        # neighbour inputs selected by idx_NN
        n_views = self.graph.opt.reg.n_views
        if "idx_NN" in var and "rgb_input_map_NN" in var:
            idx_NN = var.idx_NN
            rows = np.arange(idx_NN.shape[0])
            for v in range(n_views):
                sel = idx_NN[:, min(v, idx_NN.shape[1] - 1)]
                util_vis.tb_image(
                    opt, self.tb, step, split, f"image_input_map_NN_{v}",
                    var.rgb_input_map_NN[rows, sel], from_range=(0, 1),
                    poses=var.get(f"pose_NN_{v}"))
                util_vis.tb_image(
                    opt, self.tb, step, split, f"mask_input_map_NN_{v}",
                    var.mask_input_map_NN[rows, sel])

    # ------------------------------------------------------------------ eval
    def evaluate(self, opt, ep, training=False):
        """Chamfer-L1 (accuracy, completeness) and F-scores over the test
        loader -> the mean CD. Software-pipelined: batch k+1's forward and
        dense grid (and, on the device path, its device finish) are enqueued
        before batch k is finished (`eval3d/metrics.py::
        eval_metrics_submit`); `tpu.eval_pipeline: false` finishes each batch
        before the next is submitted. With `tpu.device_isosurface` the
        surfaces are sampled on the device, from seed = the batch index, and
        host meshes are extracted only for dumps: a training evaluation and
        `eval.dump=false` run no host marching tetrahedra and copy no grid
        to the host. A full evaluation (`training=False`) renders and dumps
        every sample unless `eval.dump` is false, and writes cd_cat.txt,
        f_score.txt and chamfer.txt; a training evaluation skips the render
        and, at its first batch, dumps the visualization samples' rotating
        views (rank 0). A ragged last batch runs at its own size.

        Under a process group test batch k runs on rank k mod W (the test
        loader's batch shard: a rank builds no other batch), on rank 0's
        BatchNorm statistics; the ranks gather the per-sample metrics and
        every rank sums them in batch order, as one process does, and
        returns the same value. Each rank dumps its own samples; rank 0
        alone writes the reports."""
        opt_e = self.graph_eval.opt
        parallel.broadcast_buffers(self.graph)
        results = []   # (it, idx, cats, cd_acc, cd_comp, f_score) a batch
        dump = (not training) and bool(opt.eval.get("dump", True))
        pipelined = opt.get("tpu", {}).get("eval_pipeline", True)

        def finish(it, var, pending, idx, cats):
            eval_3D.eval_metrics_finish(opt_e, var, pending,
                                        rng=np.random.RandomState(it),
                                        need_meshes=dump)
            results.append((it, idx, cats, np.asarray(var.cd_acc),
                            np.asarray(var.cd_comp), np.asarray(var.f_score)))
            if it == 0 and training and self.viz_data and parallel.is_main():
                if self.tb:
                    self.visualize_viz_data(opt, step=ep, split="eval")
                self._dump_rotating_vis(opt, ep)
            if dump:
                self.dump_results(opt_e, to_host(var), ep)

        with self._eval_mode():
            pending = None
            for it, batch in self.test_loader.indexed():
                cats = np.asarray(batch["category_label"])
                var = self.graph_eval(batch_to_var(batch, self.device),
                                      render=dump)
                level = eval_3D.eval_metrics_submit(
                    opt_e, var, self.graph.sdf_network, seed=it,
                    need_meshes=dump)
                if pending is not None:
                    finish(*pending)
                pending = (it, var, level, np.asarray(batch["idx"]), cats)
                if not pipelined:   # serial: finish before the next submit
                    finish(*pending)
                    pending = None
            if pending is not None:
                finish(*pending)
        if parallel.is_initialized():
            results = sorted((r for part in parallel.all_gather_object(results)
                              for r in part), key=lambda r: r[0])

        f_scores = []
        metric_eval = dict(dist_acc=0.0, dist_cov=0.0)
        acc_cat = [0.0] * opt.data.num_classes
        comp_cat = [0.0] * opt.data.num_classes
        counts_cat = [0.001] * opt.data.num_classes
        n_seen = 0
        for _, _, cats, cd_acc, cd_comp, f_score in results:
            n = len(cats)
            f_scores.append(f_score)
            n_seen += n
            for i in range(n):
                cat_idx = int(cats[i])
                counts_cat[cat_idx] += 1
                acc_cat[cat_idx] += float(cd_acc[i])
                comp_cat[cat_idx] += float(cd_comp[i])
            metric_eval["dist_acc"] += float(cd_acc.mean()) * n
            metric_eval["dist_cov"] += float(cd_comp.mean()) * n
        if not training and parallel.is_main():
            self._write_eval_reports(opt, acc_cat, comp_cat, counts_cat,
                                     f_scores)
            with open(f"{self.opt.output_path}/chamfer.txt", "w") as f:
                for _, idx, _, cd_acc, cd_comp, _ in results:
                    for i, acc, comp in zip(idx, cd_acc, cd_comp):
                        f.write(f"{i} {acc:.8f} {comp:.8f}\n")
        for key in metric_eval:
            metric_eval[key] /= max(n_seen, 1)
        if parallel.is_main():
            log.loss_eval(opt, chamfer=(metric_eval["dist_acc"],
                                        metric_eval["dist_cov"]))
        return (metric_eval["dist_acc"] + metric_eval["dist_cov"]) / 2

    def _write_eval_reports(self, opt, acc_cat, comp_cat, counts_cat,
                            f_scores):
        per_cat_cd_file = os.path.join(opt.output_path, "cd_cat.txt")
        with open(per_cat_cd_file, "w") as outfile:
            outfile.write("CD     Acc    Comp   Count Cat\n")
            for i in range(opt.data.num_classes):
                acc_i = acc_cat[i] / counts_cat[i]
                comp_i = comp_cat[i] / counts_cat[i]
                cd_i = (acc_i + comp_i) / 2
                outfile.write("%.4f %.4f %.4f %5d %s\n" % (
                    cd_i, acc_i, comp_i, counts_cat[i],
                    self.test_data.label2cat[i]))
        if f_scores:
            f_all = np.concatenate(f_scores, axis=0).mean(axis=0)
            print("##############################")
            for i, t in enumerate(opt.eval.f_thresholds):
                print("F-score @ %.2f: %.4f" % (t * 100, f_all[i]))
            print("##############################")
            with open(os.path.join(opt.output_path, "f_score.txt"), "w") as f:
                for i, t in enumerate(opt.eval.f_thresholds):
                    f.write("F-score @ %.2f: %.4f\n" % (t * 100, f_all[i]))

    def dump_results(self, opt, var, ep, train=False):
        """PNG / PLY dumps of a host (numpy) var into `dump/` (or `vis_{ep}/`
        with `train`)."""
        folder = "dump" if not train else f"vis_{ep}"
        os.makedirs(f"{self.opt.output_path}/{folder}", exist_ok=True)
        o = self.opt
        util_vis.dump_images(o, var.idx, "image_input", var.rgb_input_map,
                             from_range=(0, 1), poses=var.get("pose_gt"),
                             folder=folder)
        if "rgb_recon_map" in var:
            util_vis.dump_images(o, var.idx, "image_recon", var.rgb_recon_map,
                                 masks=var.mask_hard_map, from_range=(0, 1),
                                 poses=var.get("pose"), folder=folder)
            util_vis.dump_images(o, var.idx, "mask_recon", var.mask_recon_map,
                                 folder=folder)
        util_vis.dump_images(o, var.idx, "mask_input", var.mask_input_map,
                             folder=folder)
        if "normal_input_map" in var:
            util_vis.dump_images(o, var.idx, "normal_input_viewpoint",
                                 var.normal_input_map, from_range=(-1, 1),
                                 folder=folder)
        if "normal_transformed_map" in var:
            util_vis.dump_images(o, var.idx, "normal_input_canonical",
                                 var.normal_transformed_map,
                                 from_range=(-1, 1), folder=folder)
        if "normal_recon_map" in var:
            util_vis.dump_images(o, var.idx, "normal_recon",
                                 var.normal_recon_map, from_range=(-1, 1),
                                 folder=folder)
        if "mesh_pred" in var:
            util_vis.dump_meshes(o, var.idx, "mesh", var.mesh_pred,
                                 folder=folder)
        if "dpc_points" in var and "dpc_pred" in var:
            util_vis.dump_pointclouds_compare(
                o, var.idx, "pointclouds_comp", var.dpc_pred,
                var.dpc_points, folder=folder)

    def _dump_rotating_vis(self, opt, ep, n_views=50):
        """Per-eval dumps of the visualization samples: predicted mesh,
        pred / GT point clouds, rotating-view GIFs (reference
        `runner.py:349-357` + `dump_results(train=True)`). The renderer's
        `visualize=True` sample extras are not ported: nothing reads them."""
        opt_e = self.graph_eval.opt
        folder = f"vis_{ep}"
        with self._eval_mode():
            for batch in self.viz_data:
                var = self.graph_eval(batch_to_var(batch, self.device))
                try:
                    eval_3D.eval_metrics(opt_e, var, self.graph.sdf_network,
                                         vis_only=True,
                                         rng=np.random.RandomState(ep))
                    var = to_host(self.vis_rotate(opt, var, n_views=n_views))
                    self.dump_results(opt_e, var, ep, train=True)
                    util_vis.dump_gifs(self.opt, var.idx, "image_rotate",
                                       var.rotating_imgs, from_range=(0, 1),
                                       folder=folder)
                    util_vis.dump_gifs(self.opt, var.idx, "mask_rotate",
                                       var.rotating_masks, folder=folder)
                    util_vis.dump_gifs(self.opt, var.idx, "normal_rotate",
                                       var.rotating_normals,
                                       from_range=(0, 1), folder=folder)
                except Exception as e:  # vis must never kill training
                    log.warn(f"rotating vis failed: {e}")

    @torch.inference_mode()
    def eval_forward_and_grid(self, var):
        """Forward (encoder, estimator, eval render) + the dense SDF grid
        -> (var, level [B, vox+1, vox+1, vox+1])."""
        var = self.graph_eval(var)
        level = eval_3D.compute_level_grid(self.graph_eval.opt,
                                           self.graph.sdf_network,
                                           var.proj_latent_sdf)
        return var, level

    @trace.span("vis.rotate")
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
            with trace.span("vis.view"):
                pose_i = vis_pose[i][None].expand(B, 3, 4)
                out = self.graph_eval.render(pose_i, var.intr,
                                             torch.ones_like(var.scale_dist),
                                             var.proj_latent_sdf,
                                             var.proj_latent_rgb)
                imgs.append(trace.to_host(out.rgb.reshape(B, H, W, 3),
                                          "view").numpy())
                masks.append(trace.to_host(out.mask.reshape(B, H, W, 1),
                                           "view").numpy())
                normals.append(trace.to_host(out.normal.reshape(B, H, W, 3),
                                             "view").numpy() / 2 + 0.5)
        var.rotating_imgs = imgs
        var.rotating_masks = masks
        var.rotating_normals = normals
        return var
