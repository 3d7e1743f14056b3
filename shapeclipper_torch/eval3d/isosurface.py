"""Host-side isosurface extraction + mesh utilities (no external deps).

Replaces PyMCubes + trimesh in the reference eval path (reference
`utils/eval_3D.py:123-153`, `utils/util_vis.py:82-109`):

  * `marching_tetrahedra`: vectorized-numpy isosurface extraction. Each grid
    cube is split into 6 tetrahedra sharing the main diagonal; per-tet sign
    cases emit 0-2 triangles with linear edge interpolation. Produces the
    same isosurface as marching cubes (different triangulation) — downstream
    consumers only area-sample the surface, so metric parity holds.
  * active-cube pre-filter: only cubes whose corner values straddle the
    isovalue are processed (surface cubes are O(N^2) of the O(N^3) grid).
  * `sample_surface`: area-weighted uniform triangle sampling
    (trimesh `mesh.sample` equivalent).
  * `write_ply`: binary PLY export.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.trace import span


class Mesh(NamedTuple):
    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray     # [F, 3] int32

    @property
    def n_faces(self):
        return self.faces.shape[0]


# 6-tet decomposition of a cube; corner ids use bit order (x, y, z):
# corner = ix + 2*iy + 4*iz. All tets share the 0-7 main diagonal.
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int32)

# corner offsets (dx, dy, dz) for bit order above
_CORNERS = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                     for c in range(8)], dtype=np.int32)

# per-case triangle topology for a tetrahedron with vertices (a, b, c, d):
# case bit i set <=> vertex i is inside (value < iso). Each triangle is a
# triple of cut edges; each edge is (inside_vtx, outside_vtx).
def _tet_triangles(case):
    inside = [i for i in range(4) if case & (1 << i)]
    outside = [i for i in range(4) if not case & (1 << i)]
    if len(inside) == 0 or len(inside) == 4:
        return []
    if len(inside) == 1:
        a = inside[0]
        e = [(a, o) for o in outside]
        return [(e[0], e[1], e[2])]
    if len(inside) == 3:
        a = outside[0]
        e = [(i, a) for i in inside]
        return [(e[0], e[2], e[1])]
    # two inside (i0, i1), two outside (o0, o1): quad -> 2 triangles
    i0, i1 = inside
    o0, o1 = outside
    e00, e01 = (i0, o0), (i0, o1)
    e10, e11 = (i1, o0), (i1, o1)
    return [(e00, e10, e11), (e00, e11, e01)]


_CASE_TRIS = [_tet_triangles(c) for c in range(16)]


def marching_tetrahedra(level, isovalue=0.0):
    """level: [N, N, N] scalar field -> Mesh in index coordinates [0, N-1].

    Uses the native C++ kernel (native/scl_native.cpp) when built; the
    vectorized-numpy path below is the always-available fallback and the
    correctness reference."""
    from . import native
    verts = native.marching_tetrahedra(level, isovalue)
    if verts is not None:
        faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
        return Mesh(verts, faces)
    level = np.asarray(level, dtype=np.float32)
    N = level.shape[0]
    assert level.shape == (N, N, N)

    # active cubes: corner signs straddle the isovalue
    c = level
    corners = np.stack([
        c[:-1, :-1, :-1], c[1:, :-1, :-1], c[:-1, 1:, :-1], c[1:, 1:, :-1],
        c[:-1, :-1, 1:], c[1:, :-1, 1:], c[:-1, 1:, 1:], c[1:, 1:, 1:],
    ], axis=-1)  # [N-1, N-1, N-1, 8] in corner-bit order
    inside = corners < isovalue
    any_in = inside.any(-1)
    all_in = inside.all(-1)
    active = np.argwhere(any_in & ~all_in)  # [M, 3] cube coords
    if active.shape[0] == 0:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    cube_vals = corners[active[:, 0], active[:, 1], active[:, 2]]  # [M, 8]
    base = active.astype(np.float32)                               # [M, 3]

    tri_verts = []
    # tets: [M, 6, 4] corner ids -> values [M, 6, 4]
    tet_vals = cube_vals[:, _TETS]                                 # [M, 6, 4]
    tet_case = ((tet_vals < isovalue) <<
                np.arange(4, dtype=np.int32)).sum(-1)              # [M, 6]
    # corner positions for each tet vertex: [M, 6, 4, 3]
    tet_pos = (base[:, None, None, :]
               + _CORNERS[_TETS][None].astype(np.float32))

    flat_vals = tet_vals.reshape(-1, 4)
    flat_pos = tet_pos.reshape(-1, 4, 3)
    flat_case = tet_case.reshape(-1)

    for case in range(1, 15):
        tris = _CASE_TRIS[case]
        if not tris:
            continue
        sel = np.nonzero(flat_case == case)[0]
        if sel.size == 0:
            continue
        vals = flat_vals[sel]
        pos = flat_pos[sel]
        for tri in tris:
            pts = []
            for (a, b) in tri:
                va, vb = vals[:, a], vals[:, b]
                t = (isovalue - va) / np.where(
                    np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                t = np.clip(t, 0.0, 1.0)[:, None]
                pts.append(pos[:, a] * (1 - t) + pos[:, b] * t)
            tri_verts.append(np.stack(pts, axis=1))  # [K, 3, 3]

    tri_verts = np.concatenate(tri_verts, axis=0)
    V = tri_verts.reshape(-1, 3).astype(np.float32)
    F = np.arange(V.shape[0], dtype=np.int32).reshape(-1, 3)
    return Mesh(V, F)


@span("eval3d.mesh")
def marching_cubes_world(level, range_min, range_max, isovalue=0.0):
    """Extract + rescale vertices to world units, matching the reference's
    convention vertices/S*(max-min)+min with S = grid points per axis
    (reference `utils/eval_3D.py:140-146`)."""
    mesh = marching_tetrahedra(level, isovalue)
    S = level.shape[0]
    verts = mesh.vertices / S * (range_max - range_min) + range_min
    return Mesh(verts.astype(np.float32), mesh.faces)


def sample_surface(mesh: Mesh, n_points, rng=None):
    """Uniform area-weighted sampling on the mesh surface
    (trimesh `mesh.sample` equivalent)."""
    rng = rng or np.random
    if mesh.n_faces == 0:
        return np.zeros((n_points, 3), np.float32)
    v = mesh.vertices
    f = mesh.faces
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    total = areas.sum()
    if total <= 0:
        return np.zeros((n_points, 3), np.float32)
    probs = areas / total
    face_idx = rng.choice(len(probs), size=n_points, p=probs)
    u = rng.rand(n_points, 1)
    w = rng.rand(n_points, 1)
    flip = (u + w) > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    pts = a[face_idx] + u * (b[face_idx] - a[face_idx]) \
        + w * (c[face_idx] - a[face_idx])
    return pts.astype(np.float32)


def write_ply(path, vertices, faces=None, colors=None):
    """Binary little-endian PLY writer (mesh or point cloud)."""
    vertices = np.asarray(vertices, dtype="<f4")
    n_v = vertices.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.asarray(colors, dtype="<u1")
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        faces = np.asarray(faces, dtype="<i4")
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is not None:
            vt = np.dtype([("xyz", "<f4", 3), ("rgb", "<u1", 3)])
            rec = np.empty(n_v, vt)
            rec["xyz"] = vertices
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(vertices.tobytes())
        if faces is not None:
            ft = np.dtype([("n", "<u1"), ("idx", "<i4", 3)])
            rec = np.empty(faces.shape[0], ft)
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())
