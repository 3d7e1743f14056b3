#!/usr/bin/env python3
"""Versions of K2-bf16 (the bf16-product fused SDF backward) against each
other and against their plain references, on one NVIDIA GPU.

    git show <commit>:shapeclipper_torch/csrc/fused_sdf_bwd.cu > build/k2_ab/fma.cu
    python scripts/k2_bf16_ab.py [--build LABEL=SOURCE ...]
        [--whole LABEL=SOURCE ...] [--draws 5]

The repository's K2-bf16 (`csrc/fused_sdf_bwd_bf16.cu` with the entry of
`csrc/fused_sdf_bwd.cu`) is always the first version, `repo`. Each
`--build LABEL=SOURCE` is another version of `fused_sdf_bwd_bf16.cu`, linked
with the repository's `fused_sdf_bwd.cu`; each `--whole LABEL=SOURCE` is a
whole backward library in one source whose bf16 form walks K2's 32-point
tiles with its float32 stash (the FMA K2-bf16 of commits before the tensor
cores). All build into `build/k2_ab/` through `ops/cuda_lib.py`.

At the training render's 12 x 32,768, on `--draws` draws (the first one is
`chip_smoke.py` phase 5a's: the same network, generator and order), each
version's gradients of every SDF parameter, the latent and the points go
through the latent folding as `fused_sdf_train`'s do and are held against
the plain bf16 backward in float32 (`_CastProduct`, what phase 5a holds the
kernel to) and in float64 (the same operands rounded to bf16, sums and
elementwise work in float64): mean abs error over max|ref| per gradient,
phase 5a's gate on the first draw (max 2e-2, mean 1e-4, mean under half
the distance from the float32 K2). Then whether each version is bitwise
equal to `repo`, and CUDA-event times at 12 x 1,024 and 12 x 32,768 in
turns (a, b, ..., b, a); for a `--whole` library also whether its float32
K2 is bitwise the repository's. Prints the card, then one JSON line.
Imports no JAX.
"""

import argparse
import copy
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

OUT = os.path.join(REPO, "build", "k2_ab")
SHAPES = ((12, 1024), (12, 32768))
REPORTED = ("lin0.bias", "lin1.bias", "lin0.weight", "points", "latent")


def versions(builds, wholes):
    """-> {label: launch(points, w16, bias, sbar, fbar, gbar) -> (dw, db,
    dp)}, the same for the float32 products of the `--whole` libraries, and
    {label: ptxas usage of its bf16 kernel}, every library built at once."""
    import torch
    from shapeclipper_torch.ops import cuda_lib
    from shapeclipper_torch.ops import fused_sdf as F

    class Linked(F.FusedSdfBackwardKernel):
        stem = "k2_ab"

        def __init__(self, source):
            super().__init__(OUT)
            self.extra_sources = (source,)

    class Whole(cuda_lib.CudaLibrary):
        stem = "k2_ab_whole"

        def __init__(self, source):
            super().__init__(OUT)
            self.source = source

        def _bind(self, lib):
            fn = lib.scl_fused_sdf_bwd
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

    libs = {"repo": Linked(F._SOURCE_BWD_BF16)}
    libs.update((k, Linked(v)) for k, v in builds)
    libs.update((k, Whole(v)) for k, v in wholes)
    with ThreadPoolExecutor(len(libs)) as pool:
        for done in [pool.submit(v.build, True) for v in libs.values()]:
            done.result()

    def linked(lib):
        return lambda *a: lib.launch(*a, True, "bfloat16")

    def whole(lib):
        def launch(points, w16, bias, sbar, fbar, gbar, mm_bf16=1):
            B, N = points.shape[:2]
            dev = points.device
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            grid = min(sms, B * -(-N // F.BWD_TILE_POINTS))
            f32 = dict(device=dev, dtype=torch.float32)
            dp = torch.empty(B, N, 3, **f32)
            dw = torch.empty(F.NUM_WEIGHTS, **f32)
            db = torch.empty(B, F.BIAS_WIDTH, **f32)
            scratch = (torch.empty(grid, F.NUM_WEIGHTS, **f32),
                       torch.empty(grid, B, F.BIAS_WIDTH, **f32),
                       torch.empty(grid, F.BWD_STASH_FLOATS, **f32))
            err = lib.lib.scl_fused_sdf_bwd(
                points.data_ptr(), w16.data_ptr(), bias.data_ptr(),
                sbar.data_ptr(), fbar.data_ptr(), gbar.data_ptr(),
                dp.data_ptr(), dw.data_ptr(), db.data_ptr(),
                *[s.data_ptr() for s in scratch], B, N, grid, 1, mm_bf16,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return dw, db, dp
        return launch

    launch = {k: (whole(v) if isinstance(v, Whole) else linked(v))
              for k, v in libs.items()}
    launch_f32 = {k: whole(v) for k, v in libs.items()
                  if isinstance(v, Whole)}
    usage = {}
    for k, v in libs.items():
        name = ("fused_sdf_bwd_kernelILb1E" if isinstance(v, Whole)
                else "fused_sdf_bwd_bf16_kernel")
        try:
            usage[k] = cs.ptxas_usage(v.ptxas_log, name)
        except AssertionError:
            usage[k] = None
    return launch, launch_f32, usage


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="LABEL=SOURCE")
    ap.add_argument("--whole", action="append", default=[],
                    metavar="LABEL=SOURCE")
    ap.add_argument("--draws", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k2_bf16_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from shapeclipper_torch.models.implicit import SDFNetwork
    from shapeclipper_torch.ops import fused_sdf as F
    torch.backends.cuda.matmul.allow_tf32 = False
    split = [tuple(b.split("=", 1)) for b in args.build]
    wholes = [tuple(b.split("=", 1)) for b in args.whole]
    launch, launch_f32, usage = versions(split, wholes)
    card = cs.card_line()
    dev = torch.device("cuda")
    net = SDFNetwork(geometric_init=False, generator=torch.Generator()
                     .manual_seed(cs.SEED)).to(dev).eval()
    net64 = copy.deepcopy(net).double()

    def plain(model, pts, lat, cots, mm="bfloat16"):
        model.zero_grad()
        p = pts.clone().requires_grad_(True)
        lt = lat.clone().requires_grad_(True)
        kk, bb = F.prepare_fused_params(model, lt)
        out = F._forward_plain(kk, bb, p, *F._arch(model), True, True, mm)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        res = {n: q.grad.clone() for n, q in model.named_parameters()}
        res.update(points=p.grad.clone(), latent=lt.grad.clone())
        return res

    def kernel(fn, pts, lat, cots, mm="bfloat16"):
        net.zero_grad()
        lt = lat.clone().requires_grad_(True)
        w, b = F.pack_fused_params(*F.prepare_fused_params(net, lt))
        wk = w.detach().to(torch.bfloat16) if mm == "bfloat16" else w.detach()
        dw, db, dp = fn(pts, wk, b.detach().contiguous(),
                        cots[0][..., 0].contiguous(), cots[1], cots[2])
        torch.autograd.backward([w, b], [dw, db])
        res = {n: q.grad.clone() for n, q in net.named_parameters()}
        res.update(points=dp, latent=lt.grad.clone())
        return res

    def f32_k2(*a):
        return F.BACKWARD.launch(*a, True, "float32")

    acc = {k: [] for k in launch}
    gate = {}
    for draw in range(args.draws):
        g = torch.Generator().manual_seed(
            cs.SEED + 11 if draw == 0 else 1000 + draw)
        if draw == 0:   # phase 5a draws the eikonal case first
            torch.rand(12, 1024, 3, generator=g)
            torch.randn(12, 64, generator=g)
            for c in (1, 64, 3):
                torch.randn(12, 1024, c, generator=g)
        B, N = SHAPES[1]
        pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
        lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
        cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]
        want = plain(net, pts, lat, cots)
        want64 = plain(net64, pts.double(), lat.double(),
                       [c.double() for c in cots])
        f32 = kernel(f32_k2, pts, lat, cots, "float32")
        scale = {k: max(float(w.abs().max()), 1e-3) for k, w in want.items()}
        for label, fn in launch.items():
            got = kernel(fn, pts, lat, cots)
            torch.cuda.synchronize()
            m = {k: float((got[k] - w).abs().mean()) / scale[k]
                 for k, w in want.items()}
            m64 = {k: float((got[k].double() - w).abs().mean()) / scale[k]
                   for k, w in want64.items()}
            acc[label].append((m, m64))
            if draw == 0:
                bad = [k for k, w in want.items()
                       if float((got[k] - w).abs().max()) > 2e-2 * scale[k]
                       or m[k] > 1e-4 or (k != "lin5.bias" and m[k] >= 0.5
                       * float((got[k] - f32[k]).abs().mean()) / scale[k])]
                gate[label] = bad
        plain64 = {k: float((want[k].double() - w).abs().mean()) / scale[k]
                   for k, w in want64.items()}
        print(f"draw {draw}: the float32 plain version from the float64 one, "
              "mean / max|ref|: " + ", ".join(
                  f"{k} {plain64[k]:.3e}" for k in REPORTED), flush=True)
        for label in launch:
            m, m64 = acc[label][-1]
            print(f"draw {draw}: {label} from the float32 plain version "
                  + ", ".join(f"{k} {m[k]:.3e}" for k in REPORTED)
                  + "; from the float64 one " + ", ".join(
                      f"{k} {m64[k]:.3e}" for k in REPORTED), flush=True)

    summary = {}
    for label, rows in acc.items():
        mean = {k: sum(r[0][k] for r in rows) / len(rows) for k in REPORTED}
        mean64 = {k: sum(r[1][k] for r in rows) / len(rows)
                  for k in REPORTED}
        summary[label] = dict(ptxas=usage[label], gate_fails_draw0=gate[label],
                              mean_over_draws=mean, mean64_over_draws=mean64)
        print(f"{label} {usage[label]}: phase 5a gate on draw 0 "
              f"{'passes' if not gate[label] else 'fails ' + str(gate[label])}"
              f"; over {len(rows)} draws, lin0.bias {mean['lin0.bias']:.3e} "
              f"from the float32 plain version, {mean64['lin0.bias']:.3e} "
              "from the float64 one", flush=True)

    # bitwise against repo, then times in turns
    g = torch.Generator().manual_seed(7)
    for B, N in SHAPES:
        pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
        lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
        cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]
        with torch.no_grad():
            w, b = F.pack_fused_params(*F.prepare_fused_params(net, lat))
        a = (pts, w.to(torch.bfloat16), b, cots[0][..., 0].contiguous(),
             cots[1], cots[2])
        ref = launch["repo"](*a)
        order = list(launch) + list(launch)[::-1]
        times = {k: [] for k in launch}
        for label in order:
            times[label].append(cs.cuda_ms(lambda: launch[label](*a),
                                           calls=cs.SDF_TIMED_CALLS))
        f32_ms = cs.cuda_ms(lambda: f32_k2(*a[:1], w, *a[2:]),
                            calls=cs.SDF_TIMED_CALLS)
        for label in launch:
            out = launch[label](*a)
            same = all(torch.equal(x, y) for x, y in zip(out, ref))
            summary[label][f"ms_{B}x{N}"] = times[label]
            summary[label][f"bitwise_repo_{B}x{N}"] = same
            print(f"B={B} N={N}: {label} " + " / ".join(
                f"{t:.4f}" for t in times[label]) + " ms"
                + ("" if label == "repo" else
                   f", bitwise equal to repo: {same}"), flush=True)
        print(f"B={B} N={N}: float32 K2 {f32_ms:.4f} ms", flush=True)
        ref32 = f32_k2(*a[:1], w, *a[2:])
        for label, fn in launch_f32.items():
            same = all(torch.equal(x, y) for x, y in
                       zip(fn(*a[:1], w, *a[2:], mm_bf16=0), ref32))
            summary[label][f"f32_bitwise_repo_{B}x{N}"] = same
            print(f"B={B} N={N}: {label}'s float32 K2 bitwise equal to the "
                  f"repository's: {same}", flush=True)
        summary.setdefault("float32_K2", {})[f"ms_{B}x{N}"] = f32_ms
    print(card)
    print(json.dumps({"card": card, "versions": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
