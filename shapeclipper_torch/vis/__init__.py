"""PNG / GIF / PLY dumps used by the serving path (copied from
`shapeclipper_tpu/vis/__init__.py`: `dump_images`, `dump_gifs`,
`dump_meshes` and their helpers; the TensorBoard panels and pose overlays
are not ported). Host-side numpy/PIL; images are NHWC float.
"""

from __future__ import annotations

import os

import numpy as np
import PIL.Image

from ..eval3d.isosurface import write_ply


def to_uint8(images, from_range=(0, 1)):
    lo, hi = from_range
    x = (np.asarray(images, dtype=np.float32) - lo) / (hi - lo)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


# viridis at 0, 1/8, ..., 1 (approximate values), interpolated linearly;
# matplotlib is not a dependency of the port
_VIRIDIS = np.array([
    [0.267, 0.005, 0.329], [0.283, 0.141, 0.458], [0.230, 0.322, 0.546],
    [0.173, 0.449, 0.558], [0.128, 0.567, 0.551], [0.158, 0.684, 0.502],
    [0.369, 0.789, 0.383], [0.678, 0.864, 0.190], [0.993, 0.906, 0.144]],
    np.float32)


def _ensure_rgb(images):
    """[B,H,W,1] heatmap -> RGB via a viridis-like colormap;
    [B,H,W,3] passthrough."""
    if images.shape[-1] == 3:
        return images
    x = np.clip(images[..., 0], 0, 1) * (len(_VIRIDIS) - 1)
    i = np.minimum(x.astype(np.int64), len(_VIRIDIS) - 2)
    t = (x - i)[..., None]
    return (_VIRIDIS[i] * (1 - t) + _VIRIDIS[i + 1] * t).astype(np.float32)


def dump_images(opt, idx, name, images, from_range=(0, 1), folder="dump"):
    """Per-sample PNG dumps (reference `utils/util_vis.py:54-65`)."""
    os.makedirs(f"{opt.output_path}/{folder}", exist_ok=True)
    images = _ensure_rgb(np.asarray(images, np.float32))
    img = to_uint8(images, from_range)
    for i, sample_id in enumerate(np.asarray(idx).reshape(-1)):
        PIL.Image.fromarray(img[i]).save(
            f"{opt.output_path}/{folder}/{int(sample_id)}_{name}.png")


def dump_gifs(opt, idx, name, images_list, from_range=(0, 1), folder="dump"):
    """Rotating-view GIFs: images_list is a list of [B,H,W,C] frames
    (reference `utils/util_vis.py:68-75`)."""
    os.makedirs(f"{opt.output_path}/{folder}", exist_ok=True)
    frames_u8 = [to_uint8(_ensure_rgb(np.asarray(f, np.float32)), from_range)
                 for f in images_list]
    B = frames_u8[0].shape[0]
    for i in range(B):
        sample_id = int(np.asarray(idx).reshape(-1)[i])
        imgs = [PIL.Image.fromarray(f[i]) for f in frames_u8]
        imgs[0].save(f"{opt.output_path}/{folder}/{sample_id}_{name}.gif",
                     save_all=True, append_images=imgs[1:], duration=75,
                     loop=0)


def dump_meshes(opt, idx, name, meshes, folder="dump"):
    os.makedirs(f"{opt.output_path}/{folder}", exist_ok=True)
    for i, mesh in enumerate(meshes):
        sample_id = int(np.asarray(idx).reshape(-1)[i])
        write_ply(f"{opt.output_path}/{folder}/{sample_id}_{name}.ply",
                  mesh.vertices, mesh.faces)
