"""Checkpoint save/restore for the port (counterpart of
`shapeclipper_tpu/utils/checkpoint.py`, the graph half).

Files keep the JAX package's names with torch's suffix: `latest.pt` on every
save, copied to `best.pt` on an improved eval. Payload: epoch, iter,
best_val and `graph` (the Graph's state_dict). Optimizer states come with
the training slice.
"""

from __future__ import annotations

import math
import os
import shutil

import torch

from .log import log


def write_checkpoint(path, graph_state, ep=0, it=0, best_val=math.inf):
    """Write one checkpoint file atomically; graph_state is a state_dict."""
    payload = dict(epoch=int(ep), iter=int(it), best_val=float(best_val),
                   graph={k: v.detach().cpu() for k, v in graph_state.items()})
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(output_path, graph_state, ep=0, it=0, best_val=math.inf,
                    best=False):
    """`output_path/latest.pt`, copied to `best.pt` when `best`."""
    os.makedirs(output_path, exist_ok=True)
    latest_path = os.path.join(output_path, "latest.pt")
    write_checkpoint(latest_path, graph_state, ep, it, best_val)
    if best:
        shutil.copy(latest_path, os.path.join(output_path, "best.pt"))


def restore_checkpoint(output_path, model, load_name=None, resume=False,
                       best=False):
    """Load a checkpoint into `model` -> (epoch, iter, best_val).

    resume: `output_path/best.pt` when `best` (falling back to latest.pt),
    else `output_path/latest.pt`; otherwise the file `load_name`. The load is
    strict: a missing or unexpected key raises."""
    assert (load_name is None) == bool(resume)
    if resume:
        load_name = os.path.join(output_path,
                                 "best.pt" if best else "latest.pt")
        if best and not os.path.exists(load_name):
            log.warn("best.pt not found; falling back to latest.pt")
            load_name = os.path.join(output_path, "latest.pt")
    # weights_only: the payload holds tensors and plain numbers only
    ckpt = torch.load(load_name, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["graph"], strict=True)
    return ckpt.get("epoch"), ckpt.get("iter"), ckpt.get("best_val")
