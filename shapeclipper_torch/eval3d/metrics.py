"""3D evaluation: dense SDF grid -> isosurface -> Chamfer-L1 + F-score
(counterpart of `shapeclipper_tpu/eval3d/metrics.py`, host-isosurface
branch; reference `utils/eval_3D.py`).

  * The (vox_res+1)^3 grid evaluates on the device in chunks through
    `ops/fused_sdf.py::fused_sdf_forward(compute_grad=False)`, the Hopper
    kernel K3 on CUDA. Chunks bound the transient output ([B, chunk, 64]
    features); the last chunk may be ragged, since the kernel masks the tail.
  * `eval_metrics_submit` enqueues the grid and starts its copy into pinned
    host memory without waiting; `eval_metrics_finish` waits for that copy
    alone, runs marching tetrahedra and area-weighted surface sampling on the
    host (`np.random.RandomState` as the JAX package), then rotates and
    normalizes both clouds (Pix3D view frame), takes Chamfer-L1 through
    `ops/chamfer.py::chamfer_dists_sq` (kernel K4 on CUDA) and the F-scores
    on the device, and fetches every host-consumed metric in one copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.chamfer import chamfer_dists_sq
from ..ops.fused_sdf import fused_sdf_forward
from . import isosurface

GRID_CHUNK = 131072

# view-centric frame axis flips for Pix3D (reference `utils/eval_3D.py:78-90`)
R_TRANS_PRED_PIX3D = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
R_TRANS_GT_PIX3D = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)


def dense_grid_points(opt, N=None, device=None):
    """[(N+1)^3, 3] lattice over opt.eval.range."""
    N = N or opt.eval.vox_res
    range_min, range_max = opt.eval.range
    grid = torch.linspace(range_min, range_max, N + 1, device=device)
    pts = torch.stack(torch.meshgrid(grid, grid, grid, indexing="ij"), dim=-1)
    return pts.reshape(-1, 3)


def compute_level_grid(opt, sdf_network, proj_latent_sdf, N=None,
                       chunk=GRID_CHUNK):
    """proj_latent_sdf [B, C] -> SDF grid [B, N+1, N+1, N+1]."""
    N = N or opt.eval.vox_res
    B = proj_latent_sdf.shape[0]
    pts = dense_grid_points(opt, N, device=proj_latent_sdf.device)
    P = pts.shape[0]
    sdf = torch.empty(B, P, device=pts.device, dtype=torch.float32)
    for start in range(0, P, chunk):
        p = pts[start:start + chunk][None].expand(B, -1, 3).contiguous()
        s, _, _ = fused_sdf_forward(sdf_network, p, proj_latent_sdf,
                                    compute_grad=False)
        sdf[:, start:start + chunk] = s[..., 0]
    return sdf.reshape(B, N + 1, N + 1, N + 1)


def normalize_pc(pc):
    """Zero mean, then divided by the larger of the x and y extents
    (reference `utils/eval_3D.py:40-49`). pc [B, N, 3]."""
    pc_z = pc - pc.mean(dim=1, keepdim=True)
    length_x = pc_z[:, :, 0].amax(-1) - pc_z[:, :, 0].amin(-1)
    length_y = pc_z[:, :, 1].amax(-1) - pc_z[:, :, 1].amin(-1)
    length_max = torch.maximum(length_x, length_y)[:, None, None]
    return pc_z / (length_max + 1e-7)


def compute_fscore(dist1, dist2, thresholds):
    """dist* [B, N] (L1) -> [B, len(thresholds)]: F = 2PR / (P + R), with
    nan -> 0 (reference `utils/eval_3D.py:105-121`)."""
    fscores = []
    for threshold in thresholds:
        precision = (dist1 < threshold).float().mean(dim=1)
        recall = (dist2 < threshold).float().mean(dim=1)
        f = 2 * precision * recall / (precision + recall)
        fscores.append(torch.nan_to_num(f, nan=0.0))
    return torch.stack(fscores, dim=1)


def rotate_and_normalize_pix3d(dpc_pred, dpc_gt, pose, pose_gt):
    """Both clouds into the view frame of their pose, the Pix3D axis flips,
    then `normalize_pc` -> (pred, gt)."""
    flip_pred = torch.as_tensor(R_TRANS_PRED_PIX3D, device=dpc_pred.device)
    flip_gt = torch.as_tensor(R_TRANS_GT_PIX3D, device=dpc_gt.device)
    pred = torch.einsum("bij,bnj->bni", pose[..., :3], dpc_pred)
    gt = torch.einsum("bij,bnj->bni", pose_gt[..., :3], dpc_gt)
    pred = torch.einsum("ij,bnj->bni", flip_pred, pred)
    gt = torch.einsum("ij,bnj->bni", flip_gt, gt)
    return normalize_pc(pred), normalize_pc(gt)


def extract_meshes_and_pointclouds(opt, level_grids, rng=None):
    """Host: isosurface + area-weighted resampling per batch element ->
    (meshes, clouds [B, num_points, 3] numpy)."""
    meshes, clouds = [], []
    range_min, range_max = opt.eval.range
    for level in np.asarray(level_grids):
        mesh = isosurface.marching_cubes_world(level, range_min, range_max,
                                               isovalue=0.0)
        meshes.append(mesh)
        clouds.append(isosurface.sample_surface(mesh, opt.eval.num_points,
                                                rng=rng))
    return meshes, np.stack(clouds, axis=0)


class PendingLevel(NamedTuple):
    """A level grid enqueued on the device, its copy to the host under way.
    `ready` (CUDA only) is recorded right after the copy, so waiting on it
    does not wait on work enqueued later."""
    level: torch.Tensor
    host: torch.Tensor
    ready: object


def eval_metrics_submit(opt, var, sdf_network):
    """Stage A: enqueue the dense SDF grid for `var.proj_latent_sdf` and its
    copy to pinned host memory, and return at once. Pairs with
    `eval_metrics_finish`, so the host isosurface work of batch k overlaps the
    device computing batch k+1."""
    level = compute_level_grid(opt, sdf_network, var.proj_latent_sdf)
    if level.device.type != "cuda":
        return PendingLevel(level, level, None)
    host = torch.empty(level.shape, dtype=level.dtype, pin_memory=True)
    host.copy_(level, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(level.device))
    return PendingLevel(level, host, ready)


def eval_metrics(opt, var, sdf_network, vis_only=False, rng=None):
    """Full metric evaluation for one batch (reference
    `utils/eval_3D.py:52-103`). Sets mesh_pred / dpc_pred / f_score /
    cd_acc / cd_comp on `var`; returns (dist_acc_mean, dist_comp_mean)."""
    pending = eval_metrics_submit(opt, var, sdf_network)
    return eval_metrics_finish(opt, var, pending, vis_only=vis_only, rng=rng)


def eval_metrics_finish(opt, var, pending, vis_only=False, rng=None):
    """Stage B/C: host marching tets + sampling, then rotate / normalize,
    Chamfer-L1 and F-score on the device. `var` holds dpc_points, pose and
    pose_gt on the device. `vis_only` stops after the normalized clouds
    (returns None)."""
    if pending.ready is not None:
        pending.ready.synchronize()
    meshes, clouds = extract_meshes_and_pointclouds(
        opt, pending.host.numpy(), rng=rng)
    var.mesh_pred = meshes
    var.dpc_pred = torch.from_numpy(clouds).to(var.dpc_points.device)
    pred, gt = rotate_and_normalize_pix3d(var.dpc_pred, var.dpc_points,
                                          var.pose, var.pose_gt)
    var.dpc_pred_normalized, var.dpc_gt_normalized = pred, gt
    if vis_only:
        return None
    d1_sq, d2_sq = chamfer_dists_sq(pred.contiguous(), gt.contiguous())
    dist_acc, dist_comp = torch.sqrt(d1_sq), torch.sqrt(d2_sq)
    f_score = compute_fscore(dist_acc, dist_comp, opt.eval.f_thresholds)
    cd_acc, cd_comp = dist_acc.mean(dim=1), dist_comp.mean(dim=1)
    # one copy for every host-consumed metric
    host = torch.cat([f_score, cd_acc[:, None], cd_comp[:, None]],
                     dim=1).cpu().numpy()
    n_thr = f_score.shape[1]
    var.f_score = host[:, :n_thr]
    var.cd_acc, var.cd_comp = host[:, n_thr], host[:, n_thr + 1]
    return float(var.cd_acc.mean()), float(var.cd_comp.mean())
