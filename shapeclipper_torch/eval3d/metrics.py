"""3D evaluation: dense SDF grid -> isosurface -> Chamfer-L1 + F-score
(counterpart of `shapeclipper_tpu/eval3d/metrics.py`; reference
`utils/eval_3D.py`).

  * The (vox_res+1)^3 grid evaluates on the device in chunks through
    `ops/fused_sdf.py::fused_sdf_forward(compute_grad=False)`, the Hopper
    kernel K3 on CUDA. Chunks bound the transient output ([B, chunk, 64]
    features); the last chunk may be ragged, since the kernel masks the tail.
  * The host path (`tpu.device_isosurface` false, the default as in JAX, and
    every `vis_only` call): `eval_metrics_submit` enqueues the grid and
    starts its copy into pinned host memory without waiting;
    `eval_metrics_finish` waits for that copy alone, runs marching
    tetrahedra and area-weighted surface sampling on the host
    (`np.random.RandomState` as the JAX package), then `metric_finish`.
  * The device path (`tpu.device_isosurface` true): `metric_finish_body`
    samples the surface on the device (`device_isosurface.py`: K6 and K7 on
    CUDA, draws seeded by `seed`), then `metric_finish`. `eval_metrics_submit`
    enqueues it right behind the grid, and copies the grid to the host only
    when the caller dumps meshes (`need_meshes`).
  * `metric_finish`: both clouds rotated into the view frame and normalized
    (Pix3D), Chamfer-L1 through `ops/chamfer.py::chamfer_dists_sq` (kernel
    K4 on CUDA) and the F-scores on the device; `consume_finish_outputs`
    fetches every host-consumed metric in one copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.chamfer import chamfer_dists_sq
from ..ops.fused_sdf import fused_sdf_forward
from ..utils.trace import span, to_host
from . import device_isosurface, isosurface

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


@span("eval3d.grid")
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


def use_device_isosurface(opt):
    """`tpu.device_isosurface`: sample the evaluated surfaces on the device
    (false when absent, as in the JAX package)."""
    return bool(opt.get("tpu", {}).get("device_isosurface", False))


def metric_finish(opt, dpc_pred, dpc_gt, pose, pose_gt):
    """Rotate / normalize, Chamfer-L1 and F-scores on the clouds' device ->
    (dpc_pred, pred, gt, f_score [B, n_thr], cd_acc [B], cd_comp [B],
    acc_mean, comp_mean), the tuple `consume_finish_outputs` reads."""
    pred, gt = rotate_and_normalize_pix3d(dpc_pred, dpc_gt, pose, pose_gt)
    d1_sq, d2_sq = chamfer_dists_sq(pred.contiguous(), gt.contiguous())
    dist_acc, dist_comp = torch.sqrt(d1_sq), torch.sqrt(d2_sq)
    f_score = compute_fscore(dist_acc, dist_comp, opt.eval.f_thresholds)
    return (dpc_pred, pred, gt, f_score, dist_acc.mean(dim=1),
            dist_comp.mean(dim=1), dist_acc.mean(), dist_comp.mean())


def metric_finish_body(opt, level, dpc_gt, pose, pose_gt, seed=0,
                       draws=None):
    """The device finish: level [B, M, M, M] -> marching tetrahedra and
    area-weighted sampling of eval.num_points points (`device_isosurface`,
    draws from `seed` unless given) -> `metric_finish`. Enqueues only; no
    host copy."""
    range_min, range_max = opt.eval.range
    dpc_pred = device_isosurface.sample_level_surface_batch(
        level, int(opt.eval.num_points), range_min, range_max, seed=seed,
        draws=draws)
    return metric_finish(opt, dpc_pred, dpc_gt, pose, pose_gt)


def consume_finish_outputs(var, outs):
    """Set dpc_pred / the normalized clouds (device) and f_score / cd_acc /
    cd_comp (numpy, ONE host copy) on `var` from a `metric_finish` tuple ->
    (dist_acc_mean, dist_comp_mean)."""
    dpc_pred, pred, gt, f_score, cd_acc, cd_comp, _, _ = outs
    var.dpc_pred = dpc_pred
    var.dpc_pred_normalized, var.dpc_gt_normalized = pred, gt
    host = to_host(torch.cat([f_score, cd_acc[:, None], cd_comp[:, None]],
                             dim=1), "metrics").numpy()
    n_thr = f_score.shape[1]
    var.f_score = host[:, :n_thr]
    var.cd_acc, var.cd_comp = host[:, n_thr], host[:, n_thr + 1]
    return float(var.cd_acc.mean()), float(var.cd_comp.mean())


class PendingLevel(NamedTuple):
    """A level grid enqueued on the device. `host` is its copy to the host
    (under way on CUDA; None when no copy was asked for); `ready` (CUDA
    only) is recorded right after that copy, so waiting on it does not wait
    on work enqueued later. `outs` holds the enqueued device finish
    (`metric_finish_body`) on the device path."""
    level: torch.Tensor
    host: torch.Tensor = None
    ready: object = None
    outs: tuple = None


def _start_host_copy(level):
    if level.device.type != "cuda":
        return PendingLevel(level, level)
    host = torch.empty(level.shape, dtype=level.dtype, pin_memory=True)
    host.copy_(level, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(level.device))
    return PendingLevel(level, host, ready)


def _host_level(pending):
    """The grid on the host as numpy, waiting for its copy alone."""
    if pending.host is None:
        return to_host(pending.level, "level").numpy()
    if pending.ready is not None:
        with span("sync.level"):
            pending.ready.synchronize()
    return pending.host.numpy()


def eval_metrics_submit(opt, var, sdf_network, seed=0, need_meshes=True,
                        vis_only=False):
    """Stage A: enqueue the dense SDF grid for `var.proj_latent_sdf` and
    return at once. On the host path it also starts the grid's copy to
    pinned host memory, so that the host isosurface work of batch k overlaps
    the device computing batch k+1. On the device path (not `vis_only`) it
    enqueues the device finish from `seed` too, and copies the grid only
    when `need_meshes`."""
    level = compute_level_grid(opt, sdf_network, var.proj_latent_sdf)
    device = use_device_isosurface(opt) and not vis_only
    pending = (_start_host_copy(level) if need_meshes or not device
               else PendingLevel(level))
    if device:
        pending = pending._replace(outs=metric_finish_body(
            opt, level, var.dpc_points, var.pose, var.pose_gt, seed=seed))
    return pending


def eval_metrics(opt, var, sdf_network, vis_only=False, rng=None, seed=0,
                 need_meshes=True):
    """Full metric evaluation for one batch (reference
    `utils/eval_3D.py:52-103`). Sets mesh_pred (host path, or when
    `need_meshes`) / dpc_pred / f_score / cd_acc / cd_comp on `var`; returns
    (dist_acc_mean, dist_comp_mean)."""
    pending = eval_metrics_submit(opt, var, sdf_network, seed=seed,
                                  need_meshes=need_meshes, vis_only=vis_only)
    return eval_metrics_finish(opt, var, pending, vis_only=vis_only, rng=rng,
                               need_meshes=need_meshes)


def eval_metrics_finish(opt, var, pending, vis_only=False, rng=None,
                        need_meshes=True):
    """Stage B/C of a grid from `eval_metrics_submit`. `var` holds
    dpc_points, pose and pose_gt on the device. Device path
    (`tpu.device_isosurface`, not `vis_only`): the device finish the submit
    enqueued (its draws from the submit's `seed`), one host copy of its
    metrics, and host meshes only when `need_meshes` (dumps read them).
    Host path: host marching tets + sampling from `rng`, then
    `metric_finish`. `vis_only` stops after the normalized clouds (returns
    None)."""
    if use_device_isosurface(opt) and not vis_only:
        means = consume_finish_outputs(var, pending.outs)
        if need_meshes:
            range_min, range_max = opt.eval.range
            var.mesh_pred = [
                isosurface.marching_cubes_world(lv, range_min, range_max)
                for lv in _host_level(pending)]
        return means
    meshes, clouds = extract_meshes_and_pointclouds(
        opt, _host_level(pending), rng=rng)
    var.mesh_pred = meshes
    var.dpc_pred = torch.from_numpy(clouds).to(var.dpc_points.device)
    if vis_only:
        var.dpc_pred_normalized, var.dpc_gt_normalized = \
            rotate_and_normalize_pix3d(var.dpc_pred, var.dpc_points,
                                       var.pose, var.pose_gt)
        return None
    return consume_finish_outputs(var, metric_finish(
        opt, var.dpc_pred, var.dpc_points, var.pose, var.pose_gt))
