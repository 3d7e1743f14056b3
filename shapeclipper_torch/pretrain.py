"""Pretraining CLI on PyTorch (counterpart of the repository's
`pretrain.py`, same flags plus `--device`):

    python -m shapeclipper_torch.pretrain --yaml=options/pix3d/config.yaml \
        [--key.sub=val ...] [--device=cuda|cpu]

sphere-initialises the SDF MLP for pre.iter steps (plus the viewpoint
uniformity loss when pre.viewpoint is set) and writes `latest.pt` and
`checkpoint/ep1.pt` with the children sdf_network, latent_proj_shape (and
estimator), which `python -m shapeclipper_torch.train --load=...` restores.

`--device` defaults to cuda and raises when CUDA is absent.
"""

from __future__ import annotations

import os
import sys

from .config import options
from .train.pretrainer import Runner
from .utils.log import log


def main(argv=None):
    log.process(os.getpid())
    log.title(f"[{sys.argv[0]}] (pretraining, PyTorch)")

    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = options.pop_device(argv)
    opt_cmd = options.parse_arguments(argv)
    opt = options.set(opt_cmd=opt_cmd)
    options.save_options_file(opt)

    if opt.pre.viewpoint and opt.data.dataset == "pix3d":
        root = opt.data.get("root", "data/Pix3D")
        if not os.path.isdir(os.path.join(root, "lists")):
            log.warn(f"Pix3D assets not found under {root} — disabling the "
                     "viewpoint-uniformity loss (density-only pretraining; "
                     "sphere init does not need images, reference "
                     "model/pretrainer.py:174-181)")
            opt.pre.viewpoint = False

    trainer = Runner(opt, device)
    if opt.pre.viewpoint:
        trainer.load_dataset(opt)
    trainer.build_networks(opt)
    trainer.setup_optimizer(opt)
    trainer.train(opt)


if __name__ == "__main__":
    main()
