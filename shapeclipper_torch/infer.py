"""Single-image inference on PyTorch: image in -> reconstructed mesh + views
out (counterpart of the repository's `infer.py`, same flags plus
`--device`):

    python -m shapeclipper_torch.infer --yaml=options/pix3d/config.yaml \
        --name=run --resume --image=img.png [--mask=mask.png] \
        [--n_rotate=50] [--device=cuda|cpu]

restores the run's `best.pt` on `--resume` (or `--load=FILE`; neither keeps
the seeded initialisation), predicts the viewpoint and shape/texture
latents, and writes to `{output_path}/infer/`: `0_image_input.png`,
`0_image_recon.png`, `0_mask_recon.png`, `0_normal_recon.png`, `0_mesh.ply`
and the `0_{image,mask,normal}_rotate.gif` turntable.

`--device` defaults to cuda and raises when CUDA is absent; `--device=cpu`
runs every SDF evaluation through the kernel's plain PyTorch version.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import PIL.Image

from .config import options
from .utils.easydict import EasyDict as edict
from .utils.log import log


def load_image(opt, image_path, mask_path=None):
    """-> (rgb [1,H,W,3] f32, mask [1,H,W,1] f32), preprocessed like the
    Pix3D dataset: resize, mask binarized at 0.5, background composite."""
    image = PIL.Image.open(image_path)
    if mask_path is not None:
        mask = PIL.Image.open(mask_path).convert("L")
        image = PIL.Image.merge("RGBA", (*image.convert("RGB").split(),
                                         mask.resize(image.size)))
    elif image.mode != "RGBA":
        image = image.convert("RGBA")  # alpha defaults to opaque
    image = image.resize((opt.W, opt.H))
    arr = np.asarray(image, dtype=np.float32) / 255.0
    rgb, mask = arr[..., :3], arr[..., 3:]
    mask = (mask > 0.5).astype(np.float32)
    if opt.data.bgcolor is not None:
        rgb = rgb * mask + opt.data.bgcolor * (1 - mask)
    return rgb[None], mask[None]


def main(argv=None):
    log.process(os.getpid())
    log.title(f"[{sys.argv[0]}] (single-image inference, PyTorch)")

    argv = list(sys.argv[1:] if argv is None else argv)
    image_path, argv = options.pop_arg(argv, "image")
    mask_path, argv = options.pop_arg(argv, "mask")
    n_rotate, argv = options.pop_arg(argv, "n_rotate")
    device, argv = options.pop_device(argv)
    if not image_path:
        raise SystemExit("usage: python -m shapeclipper_torch.infer "
                         "--yaml=... --resume --image=IMG [--mask=MASK] "
                         "[--n_rotate=50] [--device=cuda|cpu]")
    n_rotate = int(n_rotate) if n_rotate else 50

    opt_cmd = options.parse_arguments(argv)
    opt = options.set(opt_cmd=opt_cmd)

    import torch

    from .eval3d import isosurface
    from .train.trainer import Runner
    from .utils import trace
    from . import vis as util_vis

    runner = Runner(opt, device)
    runner.build_networks(opt)
    runner.restore_checkpoint(opt, best=True)

    rgb, mask = load_image(opt, image_path, mask_path)
    var = edict(idx=np.array([0]),
                rgb_input_map=torch.from_numpy(rgb).to(runner.device),
                mask_input_map=torch.from_numpy(mask).to(runner.device))

    log.info("running forward + dense SDF grid...")
    var, level = runner.eval_forward_and_grid(var)

    opt_e = runner.graph_eval.opt
    folder = "infer"
    H, W = opt_e.H, opt_e.W

    def host(t, *shape):
        return trace.to_host(t.reshape(*shape), "image").numpy()

    util_vis.dump_images(opt, var.idx, "image_input", rgb, folder=folder)
    util_vis.dump_images(opt, var.idx, "image_recon",
                         host(var.rgb_recon, 1, H, W, 3), folder=folder)
    util_vis.dump_images(opt, var.idx, "mask_recon",
                         host(var.mask_recon, 1, H, W, 1), folder=folder)
    util_vis.dump_images(opt, var.idx, "normal_recon",
                         host(var.normal_recon, 1, H, W, 3) / 2 + 0.5,
                         folder=folder)

    log.info("extracting mesh...")
    range_min, range_max = opt.eval.range
    mesh = isosurface.marching_cubes_world(
        trace.to_host(level[0], "level").numpy(), range_min, range_max)
    util_vis.dump_meshes(opt, var.idx, "mesh", [mesh], folder=folder)

    if n_rotate > 0:
        log.info(f"rendering {n_rotate} rotating views...")
        var = runner.vis_rotate(opt, var, n_views=n_rotate)
        util_vis.dump_gifs(opt, var.idx, "image_rotate", var.rotating_imgs,
                           from_range=(0, 1), folder=folder)
        util_vis.dump_gifs(opt, var.idx, "mask_rotate", var.rotating_masks,
                           folder=folder)
        util_vis.dump_gifs(opt, var.idx, "normal_rotate",
                           var.rotating_normals, from_range=(0, 1),
                           folder=folder)

    out_dir = os.path.join(opt.output_path, folder)
    log.info(f"outputs written to {out_dir}:")
    for f in sorted(os.listdir(out_dir)):
        log.info(f"  {f}")


if __name__ == "__main__":
    main()
