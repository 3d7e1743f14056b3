"""TensorBoard panels and PNG / GIF / PLY dumps (copied from
`shapeclipper_tpu/vis/__init__.py`): image grids with optional mask alpha,
pose-axis and scale-text overlays (`tb_image`), per-sample PNG dumps,
rotating-view GIFs, mesh and point-cloud PLY dumps (red pred / green GT).
Host-side numpy/PIL; images are NHWC float. `tb` is any writer with
`add_image(tag, array, step, dataformats="HWC")`.
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


def draw_pose_axes(img_uint8, pose, intr=None, scale=0.3):
    """Overlay projected xyz axes (r/g/b) of a [3,4] pose onto an HxWx3
    uint8 image."""
    H, W = img_uint8.shape[:2]
    pose = np.asarray(pose)
    if intr is None:
        f = 4.0
        intr = np.array([[f * W, 0, W / 2], [0, f * H, H / 2], [0, 0, 1]],
                        dtype=np.float32)
    else:
        intr = np.asarray(intr)
    pts_world = np.concatenate(
        [np.zeros((1, 3)), np.eye(3) * scale], axis=0)    # [4, 3]
    pts_cam = pts_world @ pose[:, :3].T + pose[:, 3]
    uvw = pts_cam @ intr.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-6)
    out = img_uint8.copy()
    colors = [(255, 60, 60), (60, 255, 60), (60, 60, 255)]
    for axis in range(3):
        _draw_line(out, uv[0], uv[axis + 1], colors[axis])
    return out


def _draw_line(img, p0, p1, color, n=64):
    H, W = img.shape[:2]
    for t in np.linspace(0, 1, n):
        x = int(round(p0[0] * (1 - t) + p1[0] * t))
        y = int(round(p0[1] * (1 - t) + p1[1] * t))
        if 0 <= x < W and 0 <= y < H:
            img[y, x] = color


def draw_scale_text(img_uint8, scale_value):
    """Overlay the predicted scale as text (reference
    `utils/util_vis.py:131-142`)."""
    import PIL.ImageDraw
    im = PIL.Image.fromarray(img_uint8)
    draw = PIL.ImageDraw.Draw(im)
    draw.text((4, 4), f"scale {float(scale_value):.3f}", fill=(255, 0, 0))
    return np.asarray(im)


def image_grid(images_uint8, num_cols=8):
    B, H, W, C = images_uint8.shape
    num_cols = min(num_cols, B)
    num_rows = (B + num_cols - 1) // num_cols
    grid = np.zeros((num_rows * H, num_cols * W, C), np.uint8)
    for i in range(B):
        r, c = divmod(i, num_cols)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = images_uint8[i]
    return grid


def tb_image(opt, tb, step, group, name, images, masks=None,
             from_range=(0, 1), poses=None, intrs=None, scales=None):
    """Write an image grid to TensorBoard (reference
    `utils/util_vis.py:16-33`; `scales=` overlays the predicted scale as
    text per image, `utils/util_vis.py:26-27,131-142`)."""
    images = _ensure_rgb(np.asarray(images, np.float32))
    img = to_uint8(images, from_range)
    if masks is not None:
        m = np.asarray(masks, np.float32)
        img = (img * m + 255 * (1 - m)).astype(np.uint8)
    if poses is not None:
        img = np.stack([
            draw_pose_axes(img[i], np.asarray(poses)[i],
                           None if intrs is None else np.asarray(intrs)[i])
            for i in range(img.shape[0])])
    if scales is not None:
        sc = np.asarray(scales).reshape(-1)
        img = np.stack([draw_scale_text(img[i], sc[i])
                        for i in range(img.shape[0])])
    num_cols = opt.tb.num_images[1] if "tb" in opt else 8
    grid = image_grid(img, num_cols)
    tb.add_image(f"{group}/{name}", grid, step, dataformats="HWC")


def dump_images(opt, idx, name, images, masks=None, from_range=(0, 1),
                poses=None, folder="dump"):
    """Per-sample PNG dumps (reference `utils/util_vis.py:54-65`): `masks`
    composites on white, `poses` [B,3,4] overlays the pose axes."""
    os.makedirs(f"{opt.output_path}/{folder}", exist_ok=True)
    images = _ensure_rgb(np.asarray(images, np.float32))
    img = to_uint8(images, from_range)
    if masks is not None:
        m = np.asarray(masks, np.float32)
        img = (img * m + 255 * (1 - m)).astype(np.uint8)
    if poses is not None:
        img = np.stack([draw_pose_axes(img[i], np.asarray(poses)[i])
                        for i in range(img.shape[0])])
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


def dump_pointclouds_compare(opt, idx, name, preds, gts, folder="dump"):
    """Red pred / green GT combined point-cloud PLYs (reference
    `utils/util_vis.py:90-102`)."""
    os.makedirs(f"{opt.output_path}/{folder}", exist_ok=True)
    preds, gts = np.asarray(preds), np.asarray(gts)
    for i in range(preds.shape[0]):
        sample_id = int(np.asarray(idx).reshape(-1)[i])
        pts = np.concatenate([preds[i], gts[i]], axis=0)
        colors = np.concatenate([
            np.tile([255, 0, 0], (preds[i].shape[0], 1)),
            np.tile([0, 255, 0], (gts[i].shape[0], 1))], axis=0).astype(np.uint8)
        write_ply(f"{opt.output_path}/{folder}/{sample_id}_{name}.ply",
                  pts, colors=colors)
