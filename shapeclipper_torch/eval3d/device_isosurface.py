"""Device-side marching tetrahedra and area-weighted surface sampling
(counterpart of `shapeclipper_tpu/eval3d/device_isosurface.py`).

Every grid cell splits into the 6 main-diagonal tetrahedra of the host
path (`eval3d/isosurface.py`: the same `_TETS`, `_CORNERS` and per-case
triangles), and each tetrahedron has 2 triangle slots, masked by its sign
case: T = 12 C slots for C = (M - 1)^3 cells, flattened as (cell, tet,
slot). A surface point is drawn in proportion to area and placed by a
barycentric draw, as the host sampler does.

Two passes, each a Hopper kernel on CUDA (`ops/isosurface.py`,
`csrc/isosurface.cu`) and its plain PyTorch version here on the CPU:
  * K6, `cell_area_sums`: the summed area of each cell's 12 slots, [B, C]
    float64 (each slot's area in float32 as `triangle_areas`, summed in
    float64 in slot order);
  * the CDF over the cells, `torch.cumsum` in float64, one row a sample;
  * K7, `draw_points`: per draw, the cell whose CDF interval holds
    r * total (searchsorted, side right), then a float64 walk over that
    cell's 12 slot areas from the previous cell's CDF value to the first
    slot that passes r * total; the face's three vertices rebuilt from its
    tetrahedron's 4 corners (`_gather_face_vertices`), the barycentric
    flip, and the world scale `pts / M * (max - min) + min`, M = N + 1
    (the host's convention).
This is the distribution of the JAX package's flattened (cell, tet, slot)
CDF, with a float64 scan where JAX scans in float32 (whose rounding picks
another face for ~1 in 650 draws at M = 65), over 12x fewer entries. As
JAX, a draw that finds no slot takes the last one (face T - 1), and a
grid with no surface gives zeros.

Draws: `sample_level_surface(_batch)` takes (r, u, w), each uniform in
[0, 1): r [B, n], u and w [B, n, 1]; without them it draws those from a
`torch.Generator` on the grid's device seeded with `seed` (on the card, a
CUDA generator: the draws never leave the device). The same draws give the
same points on the card and on the CPU; the same seed gives other draws on
each.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import isosurface as kernels
from . import isosurface


def _build_case_tables():
    """Per-case triangle topology as dense arrays: for sign case c and
    triangle slot s, vertex k lies on the tet edge (EDGE_A, EDGE_B) =
    (inside vertex, outside vertex); VALID masks unused slots."""
    edge_a = np.zeros((16, 2, 3), np.int32)
    edge_b = np.zeros((16, 2, 3), np.int32)
    valid = np.zeros((16, 2), np.bool_)
    for case in range(16):
        for s, tri in enumerate(isosurface._CASE_TRIS[case]):
            valid[case, s] = True
            for k, (a, b) in enumerate(tri):
                edge_a[case, s, k] = a
                edge_b[case, s, k] = b
    return edge_a, edge_b, valid


_EDGE_A, _EDGE_B, _VALID = _build_case_tables()
_TETS = isosurface._TETS          # [6, 4] cube-corner id per tet vertex
_CORNERS = isosurface._CORNERS    # [8, 3] (dx, dy, dz); corner = x + 2y + 4z


def _table(a, device):
    return torch.as_tensor(a, device=device)


def _case(tet_vals, isovalue):
    """[..., 4] tet vertex values -> [...] sign case (bit q: vertex q
    inside, value < isovalue)."""
    bits = (tet_vals < isovalue).to(torch.int64)
    weights = torch.tensor([1, 2, 4, 8], device=tet_vals.device)
    return (bits * weights).sum(-1)


def _cell_coords(cell, n):
    return torch.stack([cell // (n * n), (cell // n) % n, cell % n], dim=-1)


def _tet_corner_data(level, isovalue):
    """level [M, M, M] -> (case [C, 6], tet_vals [C, 6, 4], base [C, 3]
    float32 cell coords), C = (M-1)^3. Corner stacking order matches the
    host `marching_tetrahedra` (bit i of the corner id is axis i)."""
    c = level
    corner_vals = torch.stack([
        c[:-1, :-1, :-1], c[1:, :-1, :-1], c[:-1, 1:, :-1], c[1:, 1:, :-1],
        c[:-1, :-1, 1:], c[1:, :-1, 1:], c[:-1, 1:, 1:], c[1:, 1:, 1:],
    ], dim=-1).reshape(-1, 8)                                   # [C, 8]
    tet_vals = corner_vals[:, _table(_TETS, level.device).long()]
    n = level.shape[0] - 1
    cell = torch.arange(n * n * n, device=level.device)
    base = _cell_coords(cell, n).to(torch.float32)
    return _case(tet_vals, isovalue), tet_vals, base


def _cell_corner_data(level, cell, isovalue):
    """`_tet_corner_data` for the listed cells only: level [M, M, M],
    cell [n] -> (case [n, 6], tet_vals [n, 6, 4], base [n, 3])."""
    M = level.shape[0]
    gi = (_cell_coords(cell, M - 1)[:, None, :]
          + _table(_CORNERS, level.device).long())                # [n, 8, 3]
    vals = level.reshape(-1)[(gi[..., 0] * M + gi[..., 1]) * M + gi[..., 2]]
    tet_vals = vals[:, _table(_TETS, level.device).long()]          # [n, 6, 4]
    base = _cell_coords(cell, M - 1).to(torch.float32)
    return _case(tet_vals, isovalue), tet_vals, base


def _lerp_vertex(va, vb, pa, pb, isovalue):
    """Edge-crossing interpolation, identical to the host path (same 1e-12
    guard and [0, 1] clip)."""
    denom = vb - va
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    t = ((isovalue - va) / denom).clamp(0.0, 1.0)[..., None]
    return pa * (1.0 - t) + pb * t


def _vertex(case, vals, cids, base, slot, k, isovalue):
    """Vertex k of triangle slot `slot` (0 or 1) of tetrahedra in sign case
    `case` [...]: their vertex values vals [..., 4], the vertices'
    cube-corner ids cids [..., 4], cell coords base [..., 3] -> [..., 3]
    float32 in grid-index coordinates."""
    dev = case.device
    sel = case * 2 + slot
    a_idx = _table(_EDGE_A.reshape(32, 3)[:, k], dev).long()[sel]
    b_idx = _table(_EDGE_B.reshape(32, 3)[:, k], dev).long()[sel]
    va = vals.gather(-1, a_idx[..., None])[..., 0]
    vb = vals.gather(-1, b_idx[..., None])[..., 0]
    corners = _table(_CORNERS, dev).to(torch.float32)
    pa = base + corners[cids.gather(-1, a_idx[..., None])[..., 0]]
    pb = base + corners[cids.gather(-1, b_idx[..., None])[..., 0]]
    return _lerp_vertex(va, vb, pa, pb, isovalue)


def _tri_vertex(case, tet_vals, base, s, k, isovalue):
    """Triangle vertex k of slot s for every (cell, tet): [..., 6, 3]
    float32 in grid-index coordinates."""
    cids = _table(_TETS, case.device).long().expand(case.shape + (4,))
    return _vertex(case, tet_vals, cids, base[..., None, :], s, k, isovalue)


def _area(p0, p1, p2):
    """0.5 |(p1 - p0) x (p2 - p0)|, each product and sum rounded on its own
    (`jnp.cross`'s terms, the squares summed x, y, z). The square root is
    taken in float64 and rounded to float32, which is the correctly rounded
    float32 root (the kernel's `__fsqrt_rn`); torch's float32 `sqrt` on the
    CPU is one ulp off for ~0.7% of inputs."""
    e1, e2 = p1 - p0, p2 - p0
    cx = e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1]
    cy = e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2]
    cz = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    ss = cx * cx + cy * cy + cz * cz
    return 0.5 * torch.sqrt(ss.double()).to(torch.float32)


def _slot_areas(case, tet_vals, base, isovalue):
    """-> [..., 6, 2] float32 slot areas; invalid slots 0."""
    valid = _table(_VALID, case.device)
    per_slot = []
    for s in (0, 1):
        p = [_tri_vertex(case, tet_vals, base, s, k, isovalue)
             for k in range(3)]
        area = _area(*p)
        per_slot.append(torch.where(valid[:, s][case], area,
                                    torch.zeros_like(area)))
    return torch.stack(per_slot, dim=-1)


def triangle_areas(level, isovalue=0.0):
    """level [M, M, M] -> areas [T] float32 with T = (M-1)^3 * 6 * 2,
    flattened as (cell, tet, slot); invalid slots have area 0."""
    case, tet_vals, base = _tet_corner_data(level, isovalue)
    return _slot_areas(case, tet_vals, base, isovalue).reshape(-1)


def _gather_face_vertices(case, tet_vals, base, slot, isovalue):
    """Re-derive the 3 vertices of the drawn faces only, from their cells'
    `_cell_corner_data` (case [n, 6], tet_vals [n, 6, 4], base [n, 3]) and
    each face's slot in its cell, slot [n] in 0..11 (tet-major) -> 3 x
    [n, 3] float32."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    tet = slot // 2
    cids = _table(_TETS, case.device).long()[tet]                   # [n, 4]
    return [_vertex(case[rows, tet], tet_vals[rows, tet], cids, base,
                    slot % 2, k, isovalue) for k in range(3)]


def _barycentric_world(p0, p1, p2, u, w, M, range_min, range_max):
    """The barycentric draw with the host sampler's flip trick, then world
    coordinates: p [n, 3], u / w [n, 1] -> [n, 3]."""
    flip = (u + w) > 1.0
    u = torch.where(flip, 1.0 - u, u)
    w = torch.where(flip, 1.0 - w, w)
    pts = p0 + u * (p1 - p0) + w * (p2 - p0)
    return pts / M * (range_max - range_min) + range_min


def cell_area_sums_plain(level, isovalue=0.0):
    """K6's plain version: level [B, M, M, M] float32 -> [B, C] float64,
    each cell's 12 slot areas (float32, `triangle_areas`) summed in float64
    in slot order."""
    out = []
    for lv in level:
        a = triangle_areas(lv, isovalue).reshape(-1, 12).double()
        s = a[:, 0]
        for k in range(1, 12):
            s = s + a[:, k]
        out.append(s)
    return torch.stack(out)


def draw_points_plain(level, cdf, r, u, w, range_min, range_max,
                      isovalue=0.0, with_faces=False):
    """K7's plain version: level [B, M, M, M], the cells' float64 CDF
    [B, C], draws r [B, n], u / w [B, n, 1] -> points [B, n, 3] float32,
    and with `with_faces` (points, faces [B, n] int64 flattened (cell, tet,
    slot))."""
    M = level.shape[1]
    C = cdf.shape[1]
    pts, faces = [], []
    for lv, cd, rb, ub, wb in zip(level, cdf, r, u, w):
        total = cd[-1]
        t = rb.double() * total
        cell = torch.searchsorted(cd, t, right=True).clamp(max=C - 1)
        acc = torch.where(cell > 0, cd[(cell - 1).clamp(min=0)],
                          torch.zeros_like(t))
        data = _cell_corner_data(lv, cell, isovalue)
        areas = _slot_areas(*data, isovalue).reshape(-1, 12).double()
        slot = torch.full_like(cell, 11)
        found = torch.zeros_like(cell, dtype=torch.bool)
        for s in range(12):
            acc = acc + areas[:, s]
            hit = ~found & (acc > t)
            slot = torch.where(hit, s, slot)
            found = found | hit
        p = _barycentric_world(*_gather_face_vertices(*data, slot, isovalue),
                               ub, wb, M, range_min, range_max)
        pts.append(torch.where(total > 0.0, p, torch.zeros_like(p)))
        faces.append(cell * 12 + slot)
    pts = torch.stack(pts)
    return (pts, torch.stack(faces)) if with_faces else pts


def cell_area_sums(level, isovalue=0.0):
    """level [B, M, M, M] float32 -> [B, C] float64 cell area sums: K6 on
    a CUDA tensor, its plain version on a CPU one."""
    if level.device.type == "cpu":
        return cell_area_sums_plain(level, isovalue)
    return kernels.KERNEL.cell_areas(level, isovalue)


def draw_points(level, cdf, r, u, w, range_min, range_max, isovalue=0.0,
                with_faces=False):
    """Points [B, n, 3] for the draws (with `with_faces`, (points, faces
    [B, n])): K7 on CUDA tensors, its plain version on CPU ones."""
    if level.device.type == "cpu":
        return draw_points_plain(level, cdf, r, u, w, range_min, range_max,
                                 isovalue, with_faces)
    return kernels.KERNEL.draw(level, cdf, r, u, w, range_min, range_max,
                               isovalue, with_faces)


def surface_draws(B, n_points, seed=0, device="cpu"):
    """(r [B, n], u [B, n, 1], w [B, n, 1]), uniform in [0, 1), from a
    generator on `device` seeded with `seed` (a CUDA generator draws other
    numbers than a CPU one from the same seed)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    r = torch.rand(B, n_points, generator=g, device=device)
    u = torch.rand(B, n_points, 1, generator=g, device=device)
    w = torch.rand(B, n_points, 1, generator=g, device=device)
    return r, u, w


def sample_level_surface_batch(level, n_points, range_min, range_max, seed=0,
                               draws=None, isovalue=0.0):
    """Area-weighted surface sampling of each grid's isosurface: level
    [B, M, M, M] -> [B, n_points, 3] float32 world coordinates (zeros for a
    grid with no surface). One K6 launch, one cumsum and one K7 launch for
    the whole batch on CUDA."""
    if draws is None:
        draws = surface_draws(level.shape[0], n_points, seed, level.device)
    r, u, w = (d.to(level.device, torch.float32, non_blocking=True)
               for d in draws)
    cdf = torch.cumsum(cell_area_sums(level, isovalue), dim=1)
    return draw_points(level, cdf, r, u, w, range_min, range_max, isovalue)


def sample_level_surface(level, n_points, range_min, range_max, seed=0,
                         draws=None, isovalue=0.0):
    """`sample_level_surface_batch` of one grid: level [M, M, M], draws
    r [n], u / w [n, 1] -> [n_points, 3]."""
    if draws is not None:
        draws = tuple(d[None] for d in draws)
    return sample_level_surface_batch(level[None], n_points, range_min,
                                      range_max, seed=seed, draws=draws,
                                      isovalue=isovalue)[0]


def triangles_for_tests(level, isovalue=0.0):
    """Every triangle slot, for parity tests on SMALL grids: level
    [M, M, M] -> (tris [T, 3, 3] float32 index coords, valid [T] bool)."""
    case, tet_vals, base = _tet_corner_data(level, isovalue)
    valid = _table(_VALID, level.device)
    slots, valids = [], []
    for s in (0, 1):
        ps = [_tri_vertex(case, tet_vals, base, s, k, isovalue)
              for k in range(3)]
        slots.append(torch.stack(ps, dim=-2))                   # [C, 6, 3, 3]
        valids.append(valid[:, s][case])
    tris = torch.stack(slots, dim=2).reshape(-1, 3, 3)
    return tris, torch.stack(valids, dim=2).reshape(-1)
