"""Train CLI on PyTorch (counterpart of the repository's `train.py`, same
flags plus `--device`):

    python -m shapeclipper_torch.train --yaml=options/pix3d/config.yaml \
        [--key.sub=val ...] [--device=cuda|cpu]

evaluates at epoch 0 (a fresh run), trains `max_epoch` epochs with an
evaluation every `freq.eval` epochs, and keeps `latest.pt`, `best.pt` (on
the Chamfer distance) and `checkpoint/ep{N}.pt` under the run's folder.
`--resume` continues from `latest.pt` (or `--resume=N` from `ep{N}.pt`),
`--load=FILE` starts from that file's weights.

`--device` defaults to cuda and raises when CUDA is absent; `--device=cpu`
runs every kernel's plain PyTorch version.

Data parallel (DDP), one process per rank:

    torchrun --nproc_per_node=W -m shapeclipper_torch.train --distributed \
        --yaml=... [--device=cpu]

joins the process group of torchrun's environment (NCCL on
`cuda:LOCAL_RANK`, gloo with `--device=cpu`); `batch_size` is the global
batch. Without torchrun's environment, or NCCL without CUDA, it raises.
"""

from __future__ import annotations

import gc
import os
import sys

from .. import parallel
from ..config import options
from ..utils.log import log
from .trainer import Runner


def main(argv=None):
    log.process(os.getpid())
    log.title(f"[{sys.argv[0]}] (training, PyTorch)")

    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = options.pop_device(argv)
    opt_cmd = options.parse_arguments(argv)
    device = parallel.join_from_cli(opt_cmd, device)
    try:
        opt = options.set(opt_cmd=opt_cmd)
        parallel.require_seed(opt)
        if parallel.is_main():
            options.save_options_file(opt)

        trainer = Runner(opt, device)
        trainer.load_dataset(opt)
        trainer.build_networks(opt)
        trainer.setup_optimizer(opt)
        trainer.restore_checkpoint(opt)
        trainer.setup_visualizer(opt)
        trainer.train(opt)
        # the DDP wrapper holds the process group: free it while the group
        # lives (a gloo rank that freed it after destroy() could hang in
        # the backend's teardown)
        del trainer
        gc.collect()
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main()
