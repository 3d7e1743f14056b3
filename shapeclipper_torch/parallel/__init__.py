"""Data parallelism over a `torch.distributed` process group (counterpart of
`shapeclipper_tpu/parallel/__init__.py`, whose 1-D 'data' mesh it replaces).

One process per rank, as the reference trained (DDP, reference
`train.py:34-41`): rank r loads positions r, r + W, ... of every global
batch (`data/base.py::DataLoader`'s shard), `DistributedDataParallel`
averages the gradients, and the few places where a step couples the samples
of the global batch call the helpers below:

  * `all_reduce_sum`: a sum over the ranks whose backward sums the incoming
    gradients over the ranks (`torch.distributed.nn`'s `all_reduce`; the
    global-batch BatchNorm moments);
  * `gather_rows`: the global batch of a per-sample tensor, rows in the
    loader's order (the trimmed normal loss, `cam_uniform`), built on
    `all_reduce` alone, so that gloo serves CUDA tensors too.

A loss that every rank computes identically from gathered tensors gives
rank r W times its own rows' share of the gradient; DDP's mean over the
ranks turns that into the global batch's gradient.

With no process group every helper is the identity: `world_size()` is 1
and `rank()` 0. Under a process group the collectives run at every world
size, one rank included, and so does the Runner's DDP wrapper.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def rank():
    return dist.get_rank() if is_initialized() else 0


def is_main():
    return rank() == 0


def barrier():
    if is_initialized():
        dist.barrier()


def init(rank_, world_size_, init_method, device_type, backend=None,
         local_rank=0):
    """Join the process group. `backend` defaults to NCCL for CUDA and gloo
    for the CPU; a caller may ask for gloo on CUDA. NCCL without CUDA (or
    a torch without NCCL) raises: there is no silent switch to gloo."""
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda but torch.cuda.is_available() "
                               "is False")
        torch.cuda.set_device(local_rank)
    if backend == "nccl":
        if device_type != "cuda":
            raise RuntimeError("the NCCL backend needs CUDA tensors; use "
                               "--device=cuda (or gloo for the CPU)")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL")
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_size_)
    return local_rank


def init_from_env(device_type, backend=None):
    """Join the process group that torchrun's environment describes ->
    the local rank."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment "
                           f"({', '.join(missing)} unset): launch with "
                           "torchrun --nproc_per_node=W -m "
                           "shapeclipper_torch.train|evaluate --distributed "
                           "...")
    env = os.environ
    return init(int(env["RANK"]), int(env["WORLD_SIZE"]),
                f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                device_type, backend, local_rank=int(env["LOCAL_RANK"]))


def join_from_cli(opt_cmd, device):
    """A CLI's `--distributed` flag (popped from `opt_cmd`): line-buffered
    stdout, since the ranks share one console, and the process group of
    torchrun's environment -> the device (`cuda:LOCAL_RANK` on CUDA)."""
    if not opt_cmd.pop("distributed", False):
        return device
    sys.stdout.reconfigure(line_buffering=True)
    local_rank = init_from_env(device)
    return f"cuda:{local_rank}" if device == "cuda" else device


def require_seed(opt):
    """Every rank must name the same run folder: a seedless run names its
    folder with a random suffix."""
    if world_size() > 1 and opt.get("seed") is None:
        raise SystemExit("--distributed needs a seed: every rank must name "
                         "the same run folder")


def destroy():
    if is_initialized():
        dist.destroy_process_group()


def check_mesh(opt):
    """`tpu.mesh: {data: N}`, when set, must name the world size."""
    spec = opt.get("tpu", {}).get("mesh")
    if not spec:
        return
    if list(spec.keys()) != ["data"]:
        raise ValueError(f"tpu.mesh: only a data axis is used, got {spec}")
    if int(spec["data"]) != world_size():
        raise ValueError(f"tpu.mesh.data={spec['data']} but the world size "
                         f"is {world_size()}")


def all_reduce_sum(x):
    """Sum of `x` over the ranks; the backward sums the gradients over the
    ranks."""
    if not is_initialized():
        return x
    return dist_nn.all_reduce(x)


def gather_rows(x):
    """The global batch of the per-sample tensor `x` [b, ...]: [b * W, ...]
    with rank q's row i at position i * W + q, the loader's order. Rows are
    placed among zeros and summed over the ranks, so the gather is exact;
    its backward hands each rank the summed gradient of its own rows."""
    if not is_initialized():
        return x
    W = world_size()
    if x.dtype == torch.bool:
        return gather_rows(x.to(torch.uint8)).bool()
    r = rank()
    parts = [x if q == r else torch.zeros_like(x) for q in range(W)]
    full = torch.stack(parts, dim=1).reshape(x.shape[0] * W, *x.shape[1:])
    return all_reduce_sum(full)


def local_rows(x):
    """This rank's rows of a global-batch tensor (the loader's order)."""
    W = world_size()
    return x if W == 1 else x[rank()::W]


def mean_over_ranks(x):
    """The mean of a detached tensor over the ranks."""
    if not is_initialized():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / world_size()


def broadcast_buffers(module):
    """Every buffer of `module` from rank 0 (DDP's forward broadcast, for
    the work that does not go through the DDP wrapper)."""
    if not is_initialized():
        return
    with torch.no_grad():
        for buf in module.buffers():
            dist.broadcast(buf, 0)


def all_gather_object(obj):
    """[rank 0's obj, rank 1's, ...]; [obj] without a process group."""
    if not is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
