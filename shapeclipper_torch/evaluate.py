"""Evaluation CLI on PyTorch (counterpart of the repository's `evaluate.py`,
same flags plus `--device`):

    python -m shapeclipper_torch.evaluate --yaml=options/pix3d/config.yaml \
        --resume [--eval.vox_res=100 ...] [--device=cuda|cpu]

restores the run's `best.pt` (falling back to `latest.pt`) non-strictly,
writes `data_list.txt` (Pix3D), and evaluates the test split: per-sample
Chamfer-L1 in `chamfer.txt`, per-category CD in `cd_cat.txt`, F-scores in
`f_score.txt`, and the PNG / PLY dumps under `dump/` unless `eval.dump` is
false.

`--device` defaults to cuda and raises when CUDA is absent; `--device=cpu`
runs every kernel's plain PyTorch version.

Over ranks, one process per rank (the JAX package evaluates over every
device of its mesh):

    torchrun --nproc_per_node=W -m shapeclipper_torch.evaluate --distributed \
        --yaml=... --resume [--device=cpu]

joins the process group of torchrun's environment (NCCL on
`cuda:LOCAL_RANK`, gloo with `--device=cpu`). Every rank restores the same
checkpoint; rank r loads and evaluates test batches r, r + W, ... only and
dumps its own samples; rank 0 gathers the per-sample metrics and alone
writes `data_list.txt` and the reports, which equal one process's. Without
torchrun's environment, NCCL without CUDA, or a `tpu.mesh.data` other than
W, it raises.
"""

from __future__ import annotations

import os
import sys

from . import parallel
from .config import options
from .utils.log import log
from .train.trainer import Runner


def main(argv=None):
    log.process(os.getpid())
    log.title(f"[{sys.argv[0]}] (evaluating, PyTorch)")

    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = options.pop_device(argv)
    opt_cmd = options.parse_arguments(argv)
    device = parallel.join_from_cli(opt_cmd, device)
    try:
        opt = options.set(opt_cmd=opt_cmd)
        parallel.require_seed(opt)

        evaluator = Runner(opt, device)
        evaluator.load_dataset(opt, eval_split="test")
        if (hasattr(evaluator.test_data, "id_filename_mapping")
                and parallel.is_main()):
            evaluator.test_data.id_filename_mapping(
                opt, os.path.join(opt.output_path, "data_list.txt"))
        evaluator.build_networks(opt)
        evaluator.setup_optimizer(opt)
        evaluator.restore_checkpoint(opt, best=True, evaluate=True)
        evaluator.setup_visualizer(opt)
        return evaluator.evaluate(opt, ep=0)
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main()
