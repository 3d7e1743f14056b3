"""The `request` traffic kind: single-image reconstruction as the serving
CLI runs it, one client in a closed loop. A request is the program's
`Runner.eval_forward_and_grid` (encoders, the eval render and the SDF
grid), `eval3d/isosurface.marching_cubes_world` on the host and
`Runner.vis_rotate` over the turntable's views; its outputs stay in
memory. Images come from a pool made at set-up; set-up runs
`warmup_requests` requests, and the window runs requests until
`--seconds` have passed, the last one to its end."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import check, inputs, program
from .. import work
from ..reference import mesh as ref_mesh
from ..reference import model as ref_model
from ..reference import step as ref_step
from .train import _no_tf32, _peak, _reset_peak, _route, _sync

METRIC = "infer_ms"


def run(cell, seed, seconds, trace, device, t_start, hooks=None):
    from shapeclipper_torch.eval3d import isosurface
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    from . import trace as tracing
    hooks = hooks or {}
    cfg, tr = cell.cfg, cell.traffic
    runner, opt, weights, buffers = program.build_runner(cfg, cell.name, seed,
                                                         device)
    runner.graph.eval()
    if "runner" in hooks:
        hooks["runner"](runner)
    images = inputs.request_images(cfg, tr, seed)
    spans = program.Spans()
    mesher = spans.wrap("marching_cubes_world")(isosurface.marching_cubes_world)
    forward = spans.wrap("eval_forward_and_grid")(runner.eval_forward_and_grid)
    turntable = spans.wrap("vis_rotate")(runner.vis_rotate)
    lo, hi = cfg["eval"]["range"]

    def request(i):
        image = images[i % len(images)]
        var = edict(idx=np.array([0]),
                    rgb_input_map=torch.from_numpy(image).to(device))
        var, level = forward(var)
        level_np = level[0].cpu().numpy()
        mesh = mesher(level_np, lo, hi)
        var = turntable(opt, var, n_views=tr["views"])
        return dict(image=i % len(images), var=var, level=level_np, mesh=mesh)

    i = 0
    for _ in range(tr["warmup_requests"]):
        request(i)
        i += 1
    _sync(device)
    setup_s = time.time() - t_start
    peak = _peak(device)
    _reset_peak(device)

    done, t0 = [], time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < seconds:
        done.append(request(i))
        i += 1
        marks.append(time.perf_counter())
    _sync(device)
    window_s = time.perf_counter() - t0
    program.report_pace("request", marks)
    peak_window = _peak(device)

    summary = None
    if trace:
        spans.ms.clear()
        with tracing.profiled(lambda: _sync(device)) as events:
            for _ in range(tr["profile_requests"]):
                request(i)
                i += 1
        He, We = cfg["eval"]["image_size"]
        S = cfg["render"]["n_samples_uniform"]
        shape = work.sdf_shape(cfg["arch"]["impl_sdf"])
        summary = tracing.Summary(events, dict(
            units=tr["profile_requests"], window_units=len(done),
            window_s=window_s, flop_per_unit=work.request_flop(cfg, tr["views"]),
            peak_mem_bytes=peak_window,
            sdf=dict(shape=tuple(shape), route=_route(shape),
                     mm=cfg["tpu"].get("implicit_dtype") or "float32",
                     mm_grid="float32",
                     fwd=[(1, He * We * S)] * (1 + tr["views"]),
                     grid=[(1, (cfg["eval"]["vox_res"] + 1) ** 3)])),
            spans=dict(spans.ms))
    peak = max(peak, _peak(device))

    rng = np.random.default_rng([int(seed), 5])
    picks = sorted(rng.choice(len(done), min(tr["compare_requests"], len(done)),
                              replace=False))
    view_ids = sorted(rng.choice(tr["views"], tr["compare_views"],
                                 replace=False))
    prog = [program_outputs(done[k], view_ids) for k in picks]
    shown = [images[done[k]["image"]] for k in picks]
    if "outputs" in hooks:
        prog = hooks["outputs"](prog)
    n_done = len(done)
    del runner, done, request, forward, turntable
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, t_ref = [], time.perf_counter()
    for out, image in zip(prog, shown):
        ref = reference(weights, buffers, cfg, image, tr["views"], view_ids,
                        device, ref_model.FLOAT32)
        numbers.append(compare(out, ref, lo, hi))
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return dict(e2e={METRIC: 1e3 * window_s / n_done, "setup_s": setup_s},
                attempted=n_done, failed=0, peak_bytes=peak,
                summary=summary, numbers=check.merge(numbers))


def program_outputs(req, view_ids):
    """What a finished request produced, as numpy, for the comparison."""
    var = req["var"]

    def host(t):
        return t.detach().float().cpu().numpy()

    mesh = req["mesh"]
    return dict(
        lat_sdf=host(var.proj_latent_sdf), lat_rgb=host(var.proj_latent_rgb),
        pose=host(var.pose),
        maps=dict(rgb=host(var.rgb_recon_map), mask=host(var.mask_recon_map),
                  normal=host(var.normal_recon_map),
                  depth=host(var.depth_recon)),
        level=req["level"],
        views=dict(rgb=[var.rotating_imgs[v] for v in view_ids],
                   mask=[var.rotating_masks[v] for v in view_ids],
                   normal=[var.rotating_normals[v] for v in view_ids]),
        triangles=np.asarray(mesh.vertices)[np.asarray(mesh.faces)])


def reference(weights, buffers, cfg, image, n_views, view_ids, device, prec):
    """The reference's request on `image` at the views `view_ids` of an
    `n_views` turntable, as numpy in the program's layouts."""
    He, We = cfg["eval"]["image_size"]
    P = {k: v.to(device) for k, v in dict(weights, **buffers).items()}
    poses = ref_model.turntable_pose(cfg, n_views, device)
    with _no_tf32():
        out = ref_step.request(P, cfg, torch.from_numpy(image).to(device),
                               poses[list(view_ids)], prec)

    def host(t):
        return t.detach().cpu().numpy()

    r = out["render"]
    return dict(
        lat_sdf=host(out["lat_sdf"]), lat_rgb=host(out["lat_rgb"]),
        pose=host(out["pose"]),
        maps=dict(rgb=host(r.rgb).reshape(1, He, We, 3),
                  mask=host(r.mask).reshape(1, He, We, 1),
                  normal=host(r.normal).reshape(1, He, We, 3),
                  depth=host(r.depth)),
        level=host(out["level"][0]),
        views=dict(rgb=[host(v.rgb).reshape(1, He, We, 3) for v in out["views"]],
                   mask=[host(v.mask).reshape(1, He, We, 1)
                         for v in out["views"]],
                   normal=[host(v.normal).reshape(1, He, We, 3) / 2 + 0.5
                           for v in out["views"]]))


def compare(prog, ref, lo, hi):
    """The numbers of one request: its outputs against the reference's,
    its mesh against the reference's isosurface of the reference's grid
    and of its own."""
    return check.request_numbers(
        prog, ref, ref_mesh.moments(prog["triangles"]),
        ref_mesh.moments(ref_mesh.triangles(ref["level"], lo, hi)),
        ref_mesh.moments(ref_mesh.triangles(prog["level"], lo, hi)))
