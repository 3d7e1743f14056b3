"""Dense SDF grid for isosurface extraction (counterpart of
`shapeclipper_tpu/eval3d/metrics.py::dense_grid_points` and
`::compute_level_grid`). The metric half (Chamfer-L1, F-score) is not
ported yet.

Every chunk of the grid goes through
`ops/fused_sdf.py::fused_sdf_forward(compute_grad=False)`, the Hopper kernel
on CUDA. Chunks bound the transient output ([B, chunk, 64] features); the
last chunk may be ragged, since the kernel masks the tail itself.
"""

from __future__ import annotations

import torch

from ..ops.fused_sdf import fused_sdf_forward

GRID_CHUNK = 131072


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
