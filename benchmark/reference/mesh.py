"""The isosurface of an SDF grid by marching tetrahedra (each cube split
into six tetrahedra around its main diagonal, linear interpolation along
the cut edges, vertices rescaled to world units as v / S * (max - min) +
min with S grid points an axis), and the moments of a triangle soup that
the comparison reads: face count, area, area-weighted centroid and signed
volume (which a flipped winding negates)."""

from __future__ import annotations

import numpy as np

# corner c = ix + 2 iy + 4 iz; the six tetrahedra share the 0-7 diagonal
TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7],
                 [0, 4, 5, 7], [0, 5, 1, 7]])
CORNERS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
                   dtype=np.float64)


def _case_triangles(case):
    """Cut edges (inside vertex, outside vertex) of each triangle of a
    tetrahedron whose vertices with bit i of `case` set are inside."""
    inside = [i for i in range(4) if case >> i & 1]
    outside = [i for i in range(4) if not case >> i & 1]
    if len(inside) == 1:
        a = inside[0]
        return [[(a, o) for o in outside]]
    if len(inside) == 3:
        e = [(i, outside[0]) for i in inside]
        return [[e[0], e[2], e[1]]]
    if len(inside) == 2:
        (i0, i1), (o0, o1) = inside, outside
        return [[(i0, o0), (i1, o0), (i1, o1)], [(i0, o0), (i1, o1), (i0, o1)]]
    return []


def triangles(level, lo, hi, iso=0.0):
    """level [S, S, S] -> triangle vertices [T, 3, 3] in world units."""
    lv = np.asarray(level, np.float64)
    S = lv.shape[0]
    idx = np.stack(np.meshgrid(*[np.arange(S - 1)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    vals = np.stack([lv[idx[:, 0] + int(c[0]), idx[:, 1] + int(c[1]),
                        idx[:, 2] + int(c[2])] for c in CORNERS], -1)
    inside = vals < iso
    active = inside.any(1) & ~inside.all(1)
    idx, vals = idx[active], vals[active]
    tris = []
    for tet in TETS:
        tv = vals[:, tet]
        tp = idx[:, None, :] + CORNERS[tet][None]
        case = (tv < iso).astype(int) @ (1 << np.arange(4))
        for c in range(1, 15):
            sel = case == c
            if not sel.any():
                continue
            v, p = tv[sel], tp[sel]
            for tri in _case_triangles(c):
                pts = []
                for a, b in tri:
                    d = v[:, b] - v[:, a]
                    t = (iso - v[:, a]) / np.where(np.abs(d) < 1e-12, 1e-12,
                                                   d)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    pts.append(p[:, a] * (1 - t) + p[:, b] * t)
                tris.append(np.stack(pts, 1))
    if not tris:
        return np.zeros((0, 3, 3))
    return np.concatenate(tris) / S * (hi - lo) + lo


def moments(tri):
    """Triangles [T, 3, 3] -> (count, area, area-weighted centroid [3],
    signed volume)."""
    tri = np.asarray(tri, np.float64)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    total = area.sum()
    centroid = ((a + b + c) / 3 * area[:, None]).sum(0) / max(total, 1e-30)
    volume = (a * np.cross(b, c)).sum() / 6.0
    return tri.shape[0], total, centroid, volume
