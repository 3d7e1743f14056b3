"""Pretraining runner: sphere-fit the SDF MLP (+ viewpoint uniformity)
(counterpart of `shapeclipper_tpu/train/pretrainer.py`), and the Adam
factory that the training runner shares.

The optimizer leaves out the estimator's backbone and its `*_head`
bottlenecks and keeps its `*_fc` layers (`pretrain_trainable`, the JAX
package's freeze mask on the port's names). Checkpoints keep the JAX
package's child-prefix contract ("reconstructor" matches nothing: a quirk
kept from the reference).
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np
import torch

from ..models.pretrain_graph import PretrainGraph
from ..utils import checkpoint as ckpt
from ..utils.easydict import EasyDict as edict
from ..utils.log import Timer, log


def make_optimizer(opt, params):
    """`torch.optim.Adam` over `params` with opt.optim.lr and the
    `opt.optim.params` overrides (`betas`, `eps`). optax's and torch's Adam
    compute the same update: lr * m_hat / (sqrt(v_hat) + eps)."""
    assert opt.optim.algo.lower() == "adam", opt.optim.algo
    kwargs = {}
    for k, v in (opt.optim.get("params") or {}).items():
        if k not in ("betas", "eps"):
            raise ValueError(f"optim.params.{k} is not supported by the port")
        kwargs[k] = tuple(v) if k == "betas" else float(v)
    return torch.optim.Adam(list(params), lr=float(opt.optim.lr), **kwargs)


def pretrain_trainable(name):
    """A parameter outside the estimator, or an estimator parameter with
    "fc" in a component of its name (the `*_fc` layers; reference
    `model/pretrainer.py:48-51`)."""
    parts = name.split(".")
    return parts[0] != "estimator" or any("fc" in p for p in parts)


class Runner:
    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda but torch.cuda.is_available() is "
                               "False")
        os.makedirs(opt.output_path, exist_ok=True)

    def load_dataset(self, opt):
        data = importlib.import_module(
            f"shapeclipper_torch.data.{opt.data.dataset}")
        log.info("loading pretrain data...")
        self.pretrain_data = data.Dataset(opt, split="train")
        self.pretrain_loader = self.pretrain_data.setup_loader(
            opt, shuffle=True, batch_size=opt.batch_size, seed=opt.seed or 0)

    def build_networks(self, opt):
        """Weights from a generator seeded with opt.seed, then the
        pretrained encoders where their .npz files exist."""
        log.info("building networks...")
        graph = PretrainGraph(opt, generator=torch.Generator().manual_seed(
            opt.seed or 0))
        graph.load_pretrained_encoders()
        self.graph = graph.to(self.device).train()
        # the steps' random draws (JAX: PRNGKey(seed + 1))
        self.generator = torch.Generator(self.device).manual_seed(
            (opt.seed or 0) + 1)

    def setup_optimizer(self, opt):
        """Adam over the `pretrain_trainable` parameters; the others stop
        taking gradients (they stay bit-identical, as under optax's
        set_to_zero; their BatchNorm statistics still move in train
        mode). A trainable parameter the loss does not reach (the encoder,
        the RGB branch) keeps no gradient, and Adam leaves it alone: optax
        steps it with a zero gradient, which leaves it unchanged too."""
        log.info("setting up optimizers...")
        self.trainable = []
        for name, p in self.graph.named_parameters():
            p.requires_grad_(pretrain_trainable(name))
            if p.requires_grad:
                self.trainable.append((name, p))
        self.optim = make_optimizer(opt, [p for _, p in self.trainable])

    def train_iteration(self, opt, var, draws=None):
        """One Adam step on `var` (see `PretrainGraph.forward`); returns
        the loss terms (detached)."""
        self.graph.train()
        self.optim.zero_grad(set_to_none=True)
        _, loss = self.graph(var, training=True, draws=draws,
                             generator=self.generator)
        loss.all.backward()
        self.optim.step()
        return edict({k: v.detach() for k, v in loss.items()})

    def train(self, opt):
        log.title("PRETRAINING START")
        timer = Timer()
        self.it = 0
        self.save_checkpoint(opt, ep=0, it=self.it + 1, latest=True)
        needs_images = bool(opt.pre.viewpoint)
        loader = iter(self.pretrain_loader) if needs_images else None
        t_log = time.time()
        for _ in range(opt.pre.iter):
            timer.begin_iter()
            var = edict()
            if needs_images:
                try:
                    batch = next(loader)
                except StopIteration:
                    loader = iter(self.pretrain_loader)
                    batch = next(loader)
                var.rgb_input_map = torch.from_numpy(
                    np.asarray(batch["rgb_input_map"])).to(self.device)
            loss = self.train_iteration(opt, var)
            if (self.it + 1) % opt.freq.ckpt_latest == 0:
                self.save_checkpoint(opt, ep=0, it=self.it + 1, latest=True)
            self.it += 1
            timer.end_iter(1, 0, opt.pre.iter)
            if time.time() - t_log > 10 or self.it == opt.pre.iter:
                print(f"  pretrain it {self.it}/{opt.pre.iter} "
                      f"loss={float(loss['all']):.4f} "
                      f"({timer.it_per_sec:.2f} it/s)")
                t_log = time.time()
        self.final_loss = {k: float(v) for k, v in loss.items()}
        self.save_checkpoint(opt, ep=1, it=self.it)
        log.title("PRETRAINING DONE")

    def save_checkpoint(self, opt, ep=0, it=0, latest=False):
        children = ("reconstructor", "sdf_network", "latent_proj_shape")
        if opt.pre.viewpoint:
            children = children + ("estimator",)
        ckpt.save_checkpoint(
            opt.output_path, self.graph.state_dict(),
            optim_states={"optim": self.optim.state_dict()},
            ep=ep, it=it, latest=latest, children=children)
        if not latest:
            log.info(f"checkpoint saved: ({opt.group}) {opt.name}, "
                     f"epoch {ep} (iteration {it})")
