"""CLIP nearest-neighbour annotation CLI on PyTorch (counterpart of the
repository's `CLIP_anno.py`, same flags plus `--device`):

    python -m shapeclipper_torch.clip_anno --yaml=options/clip/pix3d.yaml \
        [--key.sub=val ...] [--device=cuda|cpu]

writes `{anno_root}/{cats}_{train,val,test}.csv`, which the training
datasets read (`data/pix3d.py:get_NN_anno`).

`--device` defaults to cuda and raises when CUDA is absent.
"""

from __future__ import annotations

import os
import sys

from .clipnn.annotator import Pix3DAnnotator
from .config import options
from .utils.log import log


def main(argv=None):
    log.process(os.getpid())
    log.title(f"[{sys.argv[0]}] (compute CLIP-NN, PyTorch)")

    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = options.pop_device(argv)
    opt_cmd = options.parse_arguments(argv)
    opt = options.set(opt_cmd=opt_cmd)
    options.save_options_file(opt)

    if opt.data.dataset.startswith("pix3d") or opt.data.dataset == "synthetic":
        annotator = Pix3DAnnotator(opt, device)
    else:
        raise NotImplementedError(opt.data.dataset)
    annotator.load_dataset(opt)
    annotator.compute_NN(opt)


if __name__ == "__main__":
    main()
