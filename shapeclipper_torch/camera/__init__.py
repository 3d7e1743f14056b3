"""Pose algebra on [..., 3, 4] extrinsics, rays and intrinsics (counterpart
of `shapeclipper_tpu/camera/__init__.py`): rays on the dense grid (serving)
or only at the sampled pixels `ray_idx` (training).
"""

from __future__ import annotations

import torch

from ..utils.trace import span


def pose(R=None, t=None):
    """Build a [..., 3, 4] pose from rotation R [..., 3, 3] and/or t [..., 3]."""
    assert R is not None or t is not None
    if R is None:
        t = torch.as_tensor(t, dtype=torch.get_default_dtype())
        R = torch.eye(3, dtype=torch.get_default_dtype(), device=t.device).expand(
            *t.shape[:-1], 3, 3)
    elif t is None:
        R = torch.as_tensor(R, dtype=torch.get_default_dtype())
        t = torch.zeros(R.shape[:-1], dtype=torch.get_default_dtype(), device=R.device)
    else:
        R = torch.as_tensor(R, dtype=torch.get_default_dtype())
        t = torch.as_tensor(t, dtype=torch.get_default_dtype()).expand(R.shape[:-1])
    return torch.cat([R, t[..., None]], dim=-1)


def invert_pose(p):
    """Invert a [..., 3, 4] pose (rotation assumed orthonormal)."""
    R, t = p[..., :3], p[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = (-R_inv @ t)[..., 0]
    return pose(R=R_inv, t=t_inv)


def compose_pair(pose_a, pose_b):
    """pose_new(x) = pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return pose(R=R_b @ R_a, t=(R_b @ t_a + t_b)[..., 0])


def compose(pose_list):
    """pose_new(x) = poseN(...(pose2(pose1(x)))...)."""
    pose_new = pose_list[0]
    for p in pose_list[1:]:
        pose_new = compose_pair(pose_new, p)
    return pose_new


def to_hom(X):
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def cam2world(X, p):  # X: [B, N, 3], p: [..., 3, 4]
    return to_hom(X) @ invert_pose(p).transpose(-1, -2)


def img2cam(X, cam_intr):
    # torch.linalg.inv reads its error flags on the host: on CUDA, a
    # synchronisation
    with span("sync.inv"):
        inv = torch.linalg.inv(cam_intr)
    return X @ inv.transpose(-1, -2)


def transform_normal(normals, p):
    """Rotate normal vectors [B, N, 3] into the canonical frame (the
    rotation of p only)."""
    return cam2world(normals, pose(R=p[..., :3, :3]))


# ---------------------------------------------------------------------------
# angle -> rotation matrices ('rad', 'angle' (deg), 'trig' ([..., 2]))
# ---------------------------------------------------------------------------

def _get_trig(x, representation):
    if representation == "rad":
        return torch.cos(x), torch.sin(x)
    if representation == "angle":
        x = x * torch.pi / 180
        return torch.cos(x), torch.sin(x)
    if representation == "trig":
        return x[..., 0], x[..., 1]
    raise ValueError(representation)


def _rows(*rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def azim_to_rotation_matrix(azim, representation="rad"):
    """Angle with +X, rotated in the XZ plane."""
    cos, sin = _get_trig(azim, representation)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    return _rows((cos, zeros, sin), (zeros, ones, zeros), (-sin, zeros, cos))


def elev_to_rotation_matrix(elev, representation="rad"):
    """Angle with +Z in the YZ plane."""
    cos, sin = _get_trig(elev, representation)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    return _rows((ones, zeros, zeros), (zeros, cos, -sin), (zeros, sin, cos))


def roll_to_rotation_matrix(roll, representation="rad"):
    """Angle with +X in the XY plane."""
    cos, sin = _get_trig(roll, representation)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    return _rows((cos, sin, zeros), (-sin, cos, zeros), (zeros, zeros, ones))


# ---------------------------------------------------------------------------
# ray generation
# ---------------------------------------------------------------------------

def pixel_grid_xy(H, W, model="perspective", ray_idx=None, device=None):
    """2-D pixel coordinates: the full [HW, 2] grid, or [..., R, 2] at the
    flat row-major indices `ray_idx`. Perspective: pixel centres (col+0.5,
    row+0.5); orthographic: [-1, 1] ndc."""
    if ray_idx is None:
        if model == "perspective":
            y = torch.arange(H, dtype=torch.get_default_dtype(), device=device) + 0.5
            x = torch.arange(W, dtype=torch.get_default_dtype(), device=device) + 0.5
        else:
            assert H == W
            y = torch.linspace(-1.0, 1.0, H, device=device)
            x = torch.linspace(-1.0, 1.0, W, device=device)
        Y, X = torch.meshgrid(y, x, indexing="ij")
        return torch.stack([X, Y], dim=-1).reshape(-1, 2)
    row = torch.div(ray_idx, W, rounding_mode="floor").to(torch.get_default_dtype())
    col = (ray_idx % W).to(torch.get_default_dtype())
    if model == "perspective":
        x, y = col + 0.5, row + 0.5
    else:
        assert H == W
        x = -1.0 + 2.0 * col / (W - 1)
        y = -1.0 + 2.0 * row / (H - 1)
    return torch.stack([x, y], dim=-1)


def get_camera_grid(opt, batch_size, intr=None, ray_idx=None, device=None):
    """Camera-frame locations of every pixel (or of the pixels `ray_idx`
    [B, R]) on the d=1 plane."""
    model = opt.camera.model
    xy = pixel_grid_xy(opt.H, opt.W, model=model, ray_idx=ray_idx,
                       device=device)
    xy_grid = xy[None].expand(batch_size, *xy.shape) if ray_idx is None else xy
    if model == "perspective":
        grid_3D = img2cam(to_hom(xy_grid), intr)
    elif model == "orthographic":
        grid_3D = to_hom(xy_grid)
    else:
        raise ValueError(model)
    return xy_grid, grid_3D


def get_center_and_ray(opt, p, intr=None, ray_idx=None):
    """Camera centres and (unnormalized) ray directions in world coordinates
    for the dense H x W grid or the sampled pixels `ray_idx` [B, R].
    Perspective centres are [B, 1, 3]."""
    batch_size = p.shape[0]
    xy_grid, grid_3D = get_camera_grid(opt, batch_size, intr=intr,
                                       ray_idx=ray_idx, device=p.device)
    if opt.camera.model == "perspective":
        center_3D = torch.zeros(batch_size, 1, 3, dtype=grid_3D.dtype,
                                device=p.device)
    else:
        center_3D = torch.cat([xy_grid, torch.zeros_like(xy_grid[..., :1])],
                              dim=-1)
    grid_3D = cam2world(grid_3D, p)
    center_3D = cam2world(center_3D, p)
    return center_3D, grid_3D - center_3D


def get_intr(opt, scale_focal):
    """Batched pinhole intrinsics [..., 3, 3] from a per-sample focal scale."""
    scale_focal = torch.as_tensor(scale_focal, dtype=torch.get_default_dtype())
    zeros = torch.zeros_like(scale_focal)
    ones = torch.ones_like(scale_focal)
    f = opt.camera.focal * scale_focal
    intr = torch.stack([f * opt.W, zeros, ones * opt.W / 2,
                        zeros, f * opt.H, ones * opt.H / 2,
                        zeros, zeros, ones], dim=-1)
    return intr.reshape(*scale_focal.shape, 3, 3)
