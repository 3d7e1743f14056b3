"""Checkpoint save/restore for the port (counterpart of
`shapeclipper_tpu/utils/checkpoint.py`).

Files keep the JAX package's names with torch's suffix: `latest.pt` on every
save, copied to `best.pt` on an improved eval and to `checkpoint/ep{N}.pt`
on a save that is not a `latest` one. Payload: epoch, iter, best_val,
`graph` (the Graph's state_dict) and the optimizer states by name
(`optim_full`, `optim_V`: `torch.optim.Adam` state_dicts; `optim` for the
pretraining runner). `children=(...)` keeps only the top-level children
whose name starts with one of them (the pretrain -> train hand-off, which
`--load` restores per child).
"""

from __future__ import annotations

import math
import os
import shutil

import torch

from .log import log


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def write_checkpoint(path, graph_state, ep=0, it=0, best_val=math.inf,
                     optim_states=None, children=None):
    """Write one checkpoint file atomically; graph_state is a state_dict,
    optim_states a dict of name -> optimizer state_dict. With `children`,
    only the entries whose top-level name starts with one of them are kept
    (the JAX package's `k.startswith(tuple(children))`)."""
    if children is not None:
        graph_state = {k: v for k, v in graph_state.items()
                       if k.split(".")[0].startswith(tuple(children))}
    payload = dict(epoch=int(ep), iter=int(it), best_val=float(best_val),
                   graph=_to_cpu(dict(graph_state)))
    for name, state in (optim_states or {}).items():
        payload[name] = _to_cpu(state)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(output_path, graph_state, optim_states=None, ep=0, it=0,
                    best_val=math.inf, latest=False, best=False,
                    children=None):
    """`output_path/latest.pt`; copied to `best.pt` when `best` and to
    `checkpoint/ep{ep}.pt` unless `latest`."""
    os.makedirs(os.path.join(output_path, "checkpoint"), exist_ok=True)
    latest_path = os.path.join(output_path, "latest.pt")
    write_checkpoint(latest_path, graph_state, ep, it, best_val, optim_states,
                     children)
    if best:
        shutil.copy(latest_path, os.path.join(output_path, "best.pt"))
    if not latest:
        shutil.copy(latest_path, os.path.join(output_path, "checkpoint",
                                              f"ep{ep}.pt"))


def _merge_children(model, loaded):
    """Per-child restore (`--load`): each top-level child of `model` whose
    keys the checkpoint holds is loaded from it, strictly within the child;
    the others keep their weights (reference `utils/util.py:148-156`)."""
    for name, child in model.named_children():
        prefix = f"{name}."
        sub = {k[len(prefix):]: v for k, v in loaded.items()
               if k.startswith(prefix)}
        if sub:
            print(f"restoring {name}...")
            child.load_state_dict(sub, strict=True)
        else:
            print(f"skipping {name}...")


def restore_checkpoint(output_path, model, optimizers=None, load_name=None,
                       resume=False, best=False, evaluate=False):
    """Load a checkpoint into `model` (and, on resume, into `optimizers`, a
    dict of name -> torch optimizer) -> (epoch, iter, best_val).

    resume=True: `output_path/best.pt` when `best` (falling back to
    latest.pt), else `output_path/latest.pt`; resume=N: `checkpoint/epN.pt`.
    A resume loads strictly, unless `evaluate`: then whatever keys exist are
    loaded and the missing and unexpected ones are logged. Otherwise the
    file `load_name`, weights only, per top-level child (`_merge_children`);
    its epoch, iter and best_val are not returned."""
    assert (load_name is None) == (resume is not False)
    if resume:
        if best:
            load_name = os.path.join(output_path, "best.pt")
            if not os.path.exists(load_name):
                log.warn("best.pt not found; falling back to latest.pt")
                load_name = os.path.join(output_path, "latest.pt")
        elif resume is True:
            load_name = os.path.join(output_path, "latest.pt")
        else:
            load_name = os.path.join(output_path, "checkpoint",
                                     f"ep{resume}.pt")
    # weights_only: the payload holds tensors and plain values only
    ckpt = torch.load(load_name, map_location="cpu", weights_only=True)
    if not resume:
        _merge_children(model, ckpt["graph"])
        return None, None, None
    if evaluate:
        result = model.load_state_dict(ckpt["graph"], strict=False)
        if result.missing_keys:
            log.info(f"missing keys: {result.missing_keys}")
        if result.unexpected_keys:
            log.info(f"unexpected keys: {result.unexpected_keys}")
    else:
        model.load_state_dict(ckpt["graph"], strict=True)
    for name, optimizer in (optimizers or {}).items():
        if name in ckpt:
            optimizer.load_state_dict(ckpt[name])
    ep, it = ckpt.get("epoch"), ckpt.get("iter")
    print(f"resuming from epoch {ep} (iteration {it})")
    if resume is not True and not best and resume != ep:
        raise ValueError(f"{load_name} holds epoch {ep}, not {resume}")
    return ep, it, ckpt.get("best_val")
