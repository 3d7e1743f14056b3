#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each one succeeds or raises; any failure exits non-zero, and there is
no CPU fallback):
  1. set-up: versions, the card, the TF32 switches (both off: fp32 serving),
     and the build of the fused SDF kernel from `shapeclipper_torch/csrc/`
     into `build/`;
  2. the kernel against its plain PyTorch version at the serving shapes:
     N = 262,144 render points with gradients (64x64 rays x 64 samples),
     N = 274,625 and 1,030,301 grid points without (vox 64 and vox 100);
     max abs error against the stated tolerance, CUDA-event timings;
  3. four single-image requests through the port's Runner at the full width
     of options/pix3d/config.yaml (ResNet34 at 224^2, ResNet18 estimator,
     64x64x64 render, vox-64 grid, host marching tetrahedra, 8-view
     turntable), with the kernel's launch counts reset just before and read
     just after; outputs finite, mesh non-empty, request 0 held against the
     same graph run on the CPU through the plain path; then the CLI
     (`shapeclipper_torch.infer`) once on request 0's image;
  4. the kernel summary line, the card line and the result line.

Weights are the port's seeded initialisation (no trained checkpoints exist);
images are shaded ellipsoids drawn with numpy from a seed.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "options", "pix3d", "config.yaml")
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
SOURCE = "shapeclipper_torch/csrc/fused_sdf_fwd.cu"
REPLACES = "shapeclipper_tpu/ops/fused_sdf.py:311"

# tests/test_fused_sdf.py:24-27 (sdf, feature) and :41-43 (gradient)
SDF_TOL = dict(atol=2e-5, rtol=0.0)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)
N_REQUESTS = 4
N_VIEWS = 8
SEED = 0


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=10, warmup=3):
    """Median of per-call CUDA-event times after warm-up, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def within(got, want, atol, rtol):
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def load_opt():
    from shapeclipper_torch.config import options
    opt = options.load_options(CONFIG)
    opt.seed = SEED
    opt.H, opt.W = opt.image_size
    opt.output_path = OUT_DIR
    return opt


def render_points(opt_e, device):
    """The eval render's sample points for one turntable pose: [1, H*W*S, 3]."""
    import torch
    from shapeclipper_torch import camera
    from shapeclipper_torch.models.graph import pose_from_trig
    from shapeclipper_torch.render.renderer import _safe_normalize, sample_z_vals
    one = torch.ones(1, device=device)
    a = torch.tensor([[0.8, 0.6]], device=device)
    pose, intr = pose_from_trig(opt_e, a, torch.tensor([[0.96, 0.28]],
                                                       device=device),
                                torch.tensor([[1.0, 0.0]], device=device),
                                one, one)
    cam, ray = camera.get_center_and_ray(opt_e, pose, intr=intr)
    dirs = _safe_normalize(ray)
    z = sample_z_vals(opt_e, dirs.shape[1], one)
    pts = cam[:, :, None, :] + z[..., None] * dirs[:, :, None, :]
    return pts.reshape(1, -1, 3).contiguous()


# --------------------------------------------------------------- phase 2
def phase_kernels(opt):
    import torch
    from shapeclipper_torch.eval3d.metrics import dense_grid_points
    from shapeclipper_torch.models.implicit import SDFNetwork
    from shapeclipper_torch.ops import fused_sdf as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    # nn.Linear's default init everywhere (geometric_init off), so that the
    # posenc and latent rows of every layer are dense
    net = SDFNetwork(geometric_init=False, generator=g).to(dev).eval()
    latent = (torch.randn(1, 64, generator=g) * 0.3).to(dev)
    opt_e = opt.deepcopy()
    opt_e.H, opt_e.W = opt.eval.image_size
    shapes = [("grad", True, render_points(opt_e, dev))]
    for vox in (64, 100):
        shapes.append(("nograd", False, dense_grid_points(opt, vox, dev)[None]
                       .contiguous()))
    results = {"grad": [], "nograd": []}
    with torch.inference_mode():
        kernels, biases = F.prepare_fused_params(net, latent)
        weights, bias = F.pack_fused_params(kernels, biases)
        for name, cg, pts in shapes:
            N = pts.shape[1]
            k = F.fused_sdf_forward(net, pts, latent, compute_grad=cg)
            torch.cuda.synchronize()
            r = F.fused_sdf_forward_reference(net, pts, latent,
                                              compute_grad=cg)
            errs, ok = {}, True
            for part, kk, rr, tol in (("sdf", k[0], r[0], SDF_TOL),
                                      ("feat", k[1], r[1], SDF_TOL),
                                      ("grad", k[2], r[2], GRAD_TOL)):
                if rr is None:
                    continue
                if kk.shape != rr.shape or not torch.isfinite(kk).all():
                    raise AssertionError(f"{part} at N={N}: shape "
                                         f"{tuple(kk.shape)} or non-finite")
                errs[part], good = within(kk, rr, **tol)
                ok &= good
            ms = cuda_ms(lambda: F.KERNEL.launch(pts, weights, bias, cg,
                                                 True))
            plain_ms = cuda_ms(lambda: F._forward_plain(
                kernels, biases, pts, *F._arch(net), cg, True))
            log(f"[kernel] N={N} compute_grad={cg}: max abs err "
                + ", ".join(f"{p}={e:.3e}" for p, e in errs.items())
                + f" (tol sdf/feat {SDF_TOL}, grad {GRAD_TOL}); kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"({plain_ms / ms:.2f}x)")
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version at N={N}: {errs}")
            results[name].append(dict(N=N, err=max(errs.values()), ms=ms,
                                      plain_ms=plain_ms))
    return results


# --------------------------------------------------------------- phase 3
def request_image(i, H, W):
    """A shaded ellipsoid on white, like data/synthetic.py::_render_maps."""
    rng = np.random.RandomState(1000 + i)
    radii = 0.25 + 0.25 * rng.rand(3)
    color = 0.2 + 0.8 * rng.rand(3)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    u = (x + 0.5) / W * 2 - 1
    v = (y + 0.5) / H * 2 - 1
    r2 = (u / (radii[0] + 0.3)) ** 2 + (v / (radii[1] + 0.3)) ** 2
    mask = (r2 <= 1.0).astype(np.float32)[..., None]
    shade = (0.4 + 0.6 * np.sqrt(np.maximum(1.0 - r2, 0.0)))[..., None]
    rgb = color[None, None] * shade * mask + (1 - mask)
    return rgb[None].astype(np.float32)


def check_finite(name, t):
    import torch
    t = torch.as_tensor(t)
    if t.numel() == 0 or not torch.isfinite(t).all():
        raise AssertionError(f"{name}: empty or non-finite output")


def serve(runner, opt, image, stages=None):
    """One request: forward + grid, marching tets, turntable. `stages`, when
    given, collects each stage's host-clock ms (synchronised)."""
    import torch
    from shapeclipper_torch.eval3d import isosurface
    from shapeclipper_torch.utils.easydict import EasyDict as edict

    def mark(name, t0):
        if stages is not None:
            if runner.device.type == "cuda":
                torch.cuda.synchronize()
            stages.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    t = time.perf_counter()
    var = edict(idx=np.array([0]),
                rgb_input_map=torch.from_numpy(image).to(runner.device))
    var, level = runner.eval_forward_and_grid(var)
    t = mark("forward+grid", t)
    level_np = level[0].cpu().numpy()
    mesh = isosurface.marching_cubes_world(level_np, *opt.eval.range)
    t = mark("marching tets (host)", t)
    var = runner.vis_rotate(opt, var, n_views=N_VIEWS)
    mark(f"turntable ({N_VIEWS} views)", t)
    return var, level, mesh


def profile_request(runner, opt, image):
    """One more request under torch.profiler: device busy share and the
    kernels that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(runner, opt, image)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    total = sum(busy.values())
    if total <= 0:
        log("[profile] no device time in the trace: busy share not measured")
        return
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] one request under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {total:.1f} ms ({100 * total / wall_ms:.1f}%); top: "
        + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))


def phase_serve(opt):
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.train.trainer import Runner
    from shapeclipper_torch import vis as util_vis

    runner = Runner(opt, "cuda")
    runner.build_networks(opt)
    runner.restore_checkpoint(opt)
    images = [request_image(i, opt.H, opt.W) for i in range(N_REQUESTS)]
    vox = opt.eval.vox_res
    n_chunks = -(-(vox + 1) ** 3 // 131072)
    per_request = {"grad": 1 + N_VIEWS, "nograd": n_chunks}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F.KERNEL.launches = {"grad": 0, "nograd": 0}
    latencies, outputs, stages = [], [], {}
    for i, image in enumerate(images):
        before = dict(F.KERNEL.launches)
        t0 = time.perf_counter()
        var, level, mesh = serve(runner, opt, image,
                                 stages if i > 0 else None)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        delta = {k: F.KERNEL.launches[k] - before[k] for k in before}
        if delta != per_request:
            raise AssertionError(f"request {i}: kernel launches {delta}, "
                                 f"expected {per_request}")
        outputs.append((var, level, mesh))
    launches = dict(F.KERNEL.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    H, W = opt.eval.image_size
    for i, (var, level, mesh) in enumerate(outputs):
        for key in ("rgb_recon_map", "mask_recon_map", "normal_recon_map",
                    "depth_recon", "pose", "proj_latent_sdf"):
            check_finite(f"request {i} {key}", var[key])
        assert var.rgb_recon_map.shape == (1, H, W, 3)
        check_finite(f"request {i} level", level)
        assert level.shape == (1, vox + 1, vox + 1, vox + 1)
        for frames in (var.rotating_imgs, var.rotating_masks,
                       var.rotating_normals):
            assert len(frames) == N_VIEWS
            check_finite(f"request {i} turntable", np.stack(frames))
        if mesh.vertices.shape[0] == 0:
            raise AssertionError(f"request {i}: empty mesh")
        check_finite(f"request {i} mesh", mesh.vertices)
        radius = float(np.linalg.norm(mesh.vertices, axis=-1).mean())
        # the width-64 geometric init is a rough sphere of radius
        # init_sphere_radius; seeds 0-2 gave mean radii 0.485-0.593 on the
        # CPU, so hold it to 0.5 +- 0.15
        if abs(radius - opt.arch.impl_sdf.init_sphere_radius) > 0.15:
            raise AssertionError(f"request {i}: mean vertex radius {radius}")
        log(f"[serve] request {i}: {latencies[i]:.1f} ms, mesh "
            f"{mesh.vertices.shape[0]} vertices, mean radius {radius:.4f}, "
            f"mask mean {float(var.mask_recon_map.mean()):.4f}")

    # request 0 against the same graph on the CPU (the plain path)
    var0, level0, mesh0 = outputs[0]
    cpu = Runner(opt, "cpu")
    cpu.graph = copy.deepcopy(runner.graph).cpu()
    cpu.graph_eval = cpu.graph.with_opt(runner.graph_eval.opt)
    t0 = time.perf_counter()
    ref, ref_level, _ = serve(cpu, opt, images[0])
    cpu_ms = (time.perf_counter() - t0) * 1e3
    errs = {}
    for key, tol in (("proj_latent_sdf", 1e-4), ("proj_latent_rgb", 1e-4),
                     ("pose", 1e-5), ("rgb_recon_map", 1e-3),
                     ("mask_recon_map", 1e-3), ("normal_recon_map", 1e-3),
                     ("depth_recon", 1e-3)):
        errs[key], ok = within(var0[key].cpu(), ref[key], tol, tol)
        if not ok:
            raise AssertionError(f"{key}: GPU vs CPU max abs err "
                                 f"{errs[key]} > {tol}")
    errs["level"], ok = within(level0.cpu(), ref_level, 1e-4, 0.0)
    if not ok:
        raise AssertionError(f"level grid: GPU vs CPU {errs['level']}")
    errs["turntable"] = max(float(np.abs(a - b).max()) for a, b in
                            zip(var0.rotating_imgs, ref.rotating_imgs))
    if errs["turntable"] > 1e-3:
        raise AssertionError(f"turntable GPU vs CPU {errs['turntable']}")
    log("[serve] request 0 GPU vs CPU plain path (CPU took "
        f"{cpu_ms:.0f} ms): " + ", ".join(f"{k}={v:.2e}"
                                          for k, v in errs.items()))

    log("[serve] steady stages (median of requests 2-4): " + ", ".join(
        f"{k} {statistics.median(v):.1f} ms" for k, v in stages.items()))
    profile_request(runner, opt, images[1])
    util_vis.dump_images(opt, var0.idx, "image_input", images[0],
                         folder="serve")
    util_vis.dump_meshes(opt, var0.idx, "mesh", [mesh0], folder="serve")
    steady = statistics.median(latencies[1:])
    log(f"[serve] {N_REQUESTS} requests: first {latencies[0]:.1f} ms, "
        f"steady (median of 2-{N_REQUESTS}) {steady:.1f} ms, all "
        + ", ".join(f"{t:.1f}" for t in latencies)
        + f" ms; peak device memory {peak_gib:.3f} GiB; launches {launches}")
    return launches, latencies, images[0]


def phase_cli(opt, image):
    """The CLI once, on the GPU, from request 0's image written as a PNG."""
    import PIL.Image
    from shapeclipper_torch import infer
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "request0.png")
    PIL.Image.fromarray((image[0] * 255).round().astype(np.uint8)).save(path)
    t0 = time.perf_counter()
    infer.main([f"--yaml={CONFIG}", f"--output_root={OUT_DIR}",
                "--name=cli", f"--image={path}", f"--n_rotate={N_VIEWS}",
                "--device=cuda"])
    out = os.path.join(OUT_DIR, opt.group, "cli", "infer")
    for f in ("0_image_recon.png", "0_mask_recon.png", "0_normal_recon.png",
              "0_mesh.ply", "0_image_rotate.gif"):
        if not os.path.isfile(os.path.join(out, f)):
            raise AssertionError(f"CLI did not write {f}")
    log(f"[cli] python -m shapeclipper_torch.infer wrote {out} in "
        f"{time.perf_counter() - t0:.1f} s (model build included)")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "shapeclipper_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(shapeclipper_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from shapeclipper_torch.ops import fused_sdf as F

    # phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[setup] torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"python {sys.version.split()[0]}")
    log(f"[setup] device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    log(f"[setup] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    F.KERNEL.build()
    log(f"[setup] fused SDF kernel built from {SOURCE} in "
        f"{F.KERNEL.build_seconds:.2f} s -> {F.KERNEL.library_path()}")
    if F.KERNEL.ptxas_log:
        log(F.KERNEL.ptxas_log.strip())

    opt = load_opt()
    kern = phase_kernels(opt)                           # phase 2
    launches, _, image0 = phase_serve(opt)              # phase 3
    phase_cli(opt, image0)

    summary = []
    for name, key in (("fused_sdf_fwd (K1, compute_grad=True)", "grad"),
                      ("fused_sdf_fwd (K3, compute_grad=False)", "nograd")):
        main_shape = kern[key][0]
        if launches[key] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        summary.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES,
            launches=launches[key],
            max_abs_err=max(r["err"] for r in kern[key]),
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"]))
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
