"""The numbers that decide `correct`, each the gap between what the timed
path produced and what the plain reference (`benchmark/reference/`)
computes from the same weights and inputs, and its limit
(`limits/<cell>.json`, set from the readings that PERF.md lists).

Training: each compared step's loss, the first gradient of each leaf as
Adam received it (its first moment after one step over 1 - beta1) and each
leaf's change over the compared steps, each leaf's as the gap of the two
norms over the larger of the reference's norm of that leaf and of the
median leaf; the change by the worst leaf, the gradient by the worst and by
the median leaf. Beside these gaps of norms, which rounding moves only to
second order, the norm of the difference of the two first gradients over
the same scale, by the median leaf of all and of the implicit MLPs (the
SDF and RGB networks and the density); each loss term of the first step,
the terms over thresholded pixels apart; and the change by the median
leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's move by rounding alone and are left out of
the change. Which of these numbers are compared, the limits say.

Requests: the latents and pose, the eval render's maps, the SDF grid, the
mesh (its area, centroid and signed volume, against the reference's
marching tetrahedra of the reference's grid) and the turntable views
against the reference's request on the same image; beside them the mesh
against the reference's marching tetrahedra of the program's own grid
(the mesh stage alone)."""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch


def leaf_gaps(prog, ref, keep=None):
    """|prog - ref| / max(ref, median(ref)) of each leaf, for dicts of
    per-leaf norms."""
    med = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref
            if keep is None or k in keep]


IMPLICIT = ("sdf_network.", "rgb_network.", "density.")
# loss terms over pixels chosen by thresholds (mask > 0.5) and a trim by
# rank: any rounding flips some pixels in or out, so they swing by seed
THRESHOLDED = ("normal", "nearest_normal")


def train_numbers(prog, ref):
    """prog / ref: {'loss': [per step], 'terms': {name: the first step's
    loss term}, 'grad': {leaf: norm}, 'change': {leaf: norm}, 'grad_diff':
    {leaf: norm of the two first gradients' difference}} -> {name:
    value}."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["loss"], ref["loss"]))
    med = statistics.median(ref["grad"].values())
    moved = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    for key in ("grad", "change"):
        m = statistics.median(ref[key].values())
        worst = sorted(ref[key], key=lambda k: -abs(prog[key][k] - ref[key][k])
                       / max(ref[key][k], m, 1e-30))[:3]
        print(f"worst {key} leaves: " + ", ".join(
            f"{k} {prog[key][k]:.6g} against {ref[key][k]:.6g}"
            for k in worst), file=sys.stderr)
    grads = leaf_gaps(prog["grad"], ref["grad"])
    diff = {k: prog["grad_diff"][k] / max(ref["grad"][k], med, 1e-30)
            for k in ref["grad"]}
    terms = {k: abs(prog["terms"][k] - v) / abs(v)
             for k, v in ref["terms"].items() if abs(v) > 1e-12}
    changes = leaf_gaps(prog["change"], ref["change"], moved)
    return dict(loss_gap=loss,
                loss_terms_gap=max(v for k, v in terms.items()
                                   if k not in THRESHOLDED),
                normal_terms_gap=max(v for k, v in terms.items()
                                     if k in THRESHOLDED),
                change_gap_median=statistics.median(changes),
                grad_gap=max(grads),
                grad_gap_median=statistics.median(grads),
                grad_diff_median=statistics.median(diff.values()),
                mlp_grad_diff=statistics.median(
                    v for k, v in diff.items() if k.startswith(IMPLICIT)),
                change_gap=max(changes),
                **{"term_gap." + k: v for k, v in terms.items()})


def norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _mean_abs(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean())


def _moments_gap(a, b):
    n_a, area_a, cen_a, vol_a = a
    n_b, area_b, cen_b, vol_b = b
    return max(abs(area_a - area_b) / max(area_b, 1e-30),
               float(np.abs(cen_a - cen_b).max()),
               abs(vol_a - vol_b) / max(abs(vol_b), 1e-30))


def request_numbers(prog, ref, mesh_prog, mesh_ref, mesh_stage):
    """prog / ref: {'lat_sdf', 'lat_rgb', 'pose', 'maps': {name: array},
    'level', 'views': {name: [arrays]}} as numpy; mesh_*: the moments
    (`reference.mesh.moments`) of the program's mesh, of the reference's
    isosurface of its own grid and of the program's grid -> {name:
    value}."""
    latent = max(_rel_max(prog[k], ref[k]) for k in ("lat_sdf", "lat_rgb",
                                                     "pose"))
    render = max(_mean_abs(prog["maps"][k], ref["maps"][k])
                 for k in ref["maps"])
    views = max(_mean_abs(p, r) for k in ref["views"]
                for p, r in zip(prog["views"][k], ref["views"][k]))
    return dict(latent_gap=latent, render_gap=render,
                grid_gap=_rel_max(prog["level"], ref["level"]),
                mesh_gap=_moments_gap(mesh_prog, mesh_ref),
                mesh_stage_gap=_moments_gap(mesh_prog, mesh_stage),
                mesh_stage_faces_gap=float(abs(mesh_prog[0] - mesh_stage[0])),
                view_gap=views)


def merge(numbers):
    """The largest reading of each number over several comparisons."""
    out = {}
    for n in numbers:
        for k, v in n.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers, limits):
    """-> (correct, {name: {'value', 'limit'}}) over the numbers that have
    a limit; a number that is not finite fails."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return bool(ok), checks
