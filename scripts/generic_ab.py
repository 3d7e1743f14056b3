#!/usr/bin/env python3
"""Time versions of the generic fused SDF pair against each other on one
NVIDIA GPU, in its bf16 forms (K8-bf16, K8-nograd-bf16 and K9-bf16 of
`csrc/fused_sdf_generic_bf16.cu`) or, with `--mm float32`, its float32
forms (K8, K8-nograd and K9 of `csrc/fused_sdf_generic.cu`), at the wide
SDF MLP (`chip_smoke.GENERIC_WIDE`, VolSDF's 8 x 256 with a skip at layer
4) at the eikonal's 12 x 1,024 and the merged render's 24 x 32,768, or at
the shapes `--shape BxN` names (1x262144: a request's render).

    mkdir -p build/v/old
    for f in fused_sdf_generic.cu fused_sdf_generic_bf16.cu fused_sdf_generic.cuh
    do git show <commit>:shapeclipper_torch/csrc/$f > build/v/old/$f; done
    python scripts/generic_ab.py --build new=shapeclipper_torch/csrc \\
        --build old=build/v/old [--mm float32] [--ablate nostash ...]

Each `--build LABEL=DIR` names a directory that holds the library's three
sources under their repository names (a `fused_sdf_generic.cu` from before
the tf32 pack, the float32 FMA forms of commit 66a08da and earlier, reads
the float32 weights as they are; one from before K8-bf16's wgmma form
runs its mma.sync form at every width, on the same pack, whose chunk
images it leaves unread); `--ablate NAME` adds a build of the
repository's sources with one part of the bf16 kernels cut out (its results
are wrong: it times what is left; `ABLATIONS` says what each cuts). All are
compiled by nvcc for sm_90a at once (`ops/cuda_lib.py::CudaLibrary.build`)
into `build/generic_ab/`; each build's registers and spills of its kernels
are printed from ptxas. At 12 x 1,024 every build's K9 (in the chosen form)
is held against the float64 plain version of that form
(`chip_smoke.generic_backward_plain`; the largest error over max|ref| of
each gradient is printed), and K8's largest error against the float32 plain
version; at a shape of 100,000 points or more each build's K8 (in the
chosen form) against its plain version in that form (max and mean error
of sdf, feature, gradient). Each shape times the builds in two rounds, in order and then in
reverse (a, b, b, a): K8 and K8-nograd over 20 launches (3 at 24 x 32,768)
and K9 over 20 (2) between two CUDA events, each with its weight pack.
Prints one line a build and round and the card, then one JSON line of the
results. Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

OUT = os.path.join(REPO, "build", "generic_ab")
FILES = ("fused_sdf_generic.cu", "fused_sdf_generic_bf16.cu",
         "fused_sdf_generic.cuh")

# name -> (what it cuts, [(text of the bf16 source, its replacement)])
ABLATIONS = {
    "nomma": ("the products' mma.sync (each replaced by a float add that "
              "reads its ldmatrix fragments)", [(
                  """          mma16816(acc[m][2 * np], a[m], b[0], b[1]);
          mma16816(acc[m][2 * np + 1], a[m], b[2], b[3]);""",
                  """          acc[m][2 * np][0] += __uint_as_float(b[0] ^ a[m][0]);
          acc[m][2 * np + 1][0] += __uint_as_float(b[2] ^ a[m][1]);""")]),
    "noproduct": ("the products' fragment loads and mma.sync (chunk loads, "
                  "barriers and epilogues kept)", [(
                      "    if (wn0 >= nmax) continue;\n", "    continue;\n")]),
    "noepi": ("the forward's activation (the identity in its place)", [(
        """              float act, sig;
              act_pair_fast(prim, act, sig);""",
        """              float act = prim, sig = 1.f;""")]),
    "nowg": ("K9's weight gradient", [(
        "      weight_grad(a, t, l, h, pe, cot, dk + a.woff[l]);\n", "")]),
    "nowgrmw": ("the weight gradient's read-modify-write of the partials "
                "(its products kept)", [(
                    """            if (pairs) {
              v = *reinterpret_cast<const float2*>(dk + r + n);
            } else {
              v.x = dk[r + n];
              if (n + 1 < Nl) v.y = dk[r + n + 1];
            }""", ""), (
                    """          if (pairs) {
            *reinterpret_cast<float2*>(dk + r + n) = make_float2(x, y);
          } else {""",
                    """          if (x == 12345.f) {
            *reinterpret_cast<float2*>(dk + r + n) = make_float2(x, y);
          } else if (y == 54321.f) {""")]),
    "nostash": ("K9's stash stores and loads (fixed values read)", [(
        """              if (stash)
                *reinterpret_cast<float4*>(""",
        """              if (stash && prim == 12345.f)
                *reinterpret_cast<float4*>("""), (
        """                const float4 s4 = *reinterpret_cast<const float4*>(
                    stash +
                    stash_at(passes, l - 1, pass, warp, 2 * nt + e, lane));""",
        """                const float4 s4 = make_float4(0.01f * dx, 0.1f, 0.2f,
                                              0.3f);"""), (
        """                const float4 s4 = *reinterpret_cast<const float4*>(
                    stash +
                    stash_at(passes, l - 2, pass, warp, 2 * nt + e, lane));""",
        """                const float4 s4 = make_float4(0.01f * n, 0.1f, 0.2f,
                                              0.3f);""")]),
    "wgnoepi": ("K8-bf16 wgmma form: the hidden layers' activation and its "
                "shuffles (the sums stored as they are)", [(
                    """          const float sent = __shfl_xor_sync(0xffffffffu, v1, 16);
          float act = 0.f, sig = 0.f;
          if ((prim_lane ? c0 : c0 + 1) < W)
            act_pair_fast(prim_lane ? v0 : sent, act, sig);
          const float sig_o = __shfl_xor_sync(0xffffffffu, sig, 16);
          const float act_o = __shfl_xor_sync(0xffffffffu, act, 16);""",
                    """          const float act = v0, sig = 1.f, sig_o = 1.f, act_o = v1;""")]),
    "wgnomma": ("K8-bf16 wgmma form: its wgmma products (ring, waits and "
                "epilogues kept)", [(
                    """          wgmma_n256(d, da + 2 * ks, db + 2 * ks, acc);
          if (wide) wgmma_n16(d16, da + 2 * ks, db + kWgN * 8 + 2 * ks, acc);""",
                    """          d[ks] += (float)(da + db + acc);""")]),
    "wgnoload": ("K8-bf16 wgmma form: the weight chunks' bulk copies (the "
                 "full barriers arrived on without bytes)", [(
                     """            mbar_expect_tx(full + stage, bytes);
            bulk_g2s(ring + stage * w.stage_bytes, src, bytes, full + stage);""",
                     """            mbar_arrive(full + stage);""")]),
    "noprefetch": ("the L2 prefetch of the stash before each input-cotangent "
                   "pass", [(
                       "              prefetch_l2(stash + ",
                       "              if (layer < -1) prefetch_l2(stash + ")]),
}


def ablated(name, dest):
    """The repository's sources into `dest`, the bf16 one with ablation
    `name` applied (each text must occur exactly once)."""
    src = os.path.join(REPO, "shapeclipper_torch", "csrc")
    os.makedirs(dest, exist_ok=True)
    for f in FILES:
        with open(os.path.join(src, f)) as fh:
            text = fh.read()
        if f == "fused_sdf_generic_bf16.cu":
            for old, new in ABLATIONS[name][1]:
                if text.count(old) != 1:
                    raise SystemExit(f"ablation {name}: its text occurs "
                                     f"{text.count(old)} times in {f}")
                text = text.replace(old, new)
        with open(os.path.join(dest, f), "w") as fh:
            fh.write(text)
    return dest


def _bind_fma(self, lib):
    """The C interface of a library without the tf32 pack (float32 FMA
    forms that read the float32 weights)."""
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.scl_sdf_generic_fwd.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.scl_sdf_generic_bwd.argtypes = [p] * 10 + [i] * 9 + [p]
    lib.scl_sdf_generic_pack_bf16.argtypes = [p] * 2 + [i] * 4 + [p]
    lib.scl_sdf_generic_tile_points.argtypes = [i] * 7
    lib.scl_sdf_generic_stash_floats.argtypes = [i] * 5
    lib.scl_sdf_generic_bwd_blocks_per_sm.argtypes = [i] * 5
    for name in ("fwd", "bwd", "pack_bf16", "tile_points", "stash_floats",
                 "bwd_blocks_per_sm"):
        getattr(lib, f"scl_sdf_generic_{name}").restype = i


def _bind_mma_sync(self, lib):
    """The C interface of a library from before K8-bf16's wgmma form (no
    `scl_sdf_generic_fwd_form`; its bf16 pack has no chunk images)."""
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.scl_sdf_generic_fwd.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.scl_sdf_generic_bwd.argtypes = [p] * 10 + [i] * 9 + [p]
    lib.scl_sdf_generic_tile_points.argtypes = [i] * 7
    lib.scl_sdf_generic_stash_floats.argtypes = [i] * 5
    lib.scl_sdf_generic_bwd_blocks_per_sm.argtypes = [i] * 5
    for kind in ("bf16", "tf32"):
        getattr(lib, f"scl_sdf_generic_pack_{kind}").argtypes = \
            [p] * 2 + [i] * 4 + [p]
    for name in ("fwd", "bwd", "tile_points", "stash_floats",
                 "bwd_blocks_per_sm", "pack_bf16", "pack_tf32"):
        getattr(lib, f"scl_sdf_generic_{name}").restype = i


def _key_mma_sync(self, lib, arch, compute_grad, mm_dtype):
    return ("grad" if compute_grad else "nograd") + (
        "_bf16" if mm_dtype == "bfloat16" else "")


def _weights_fma(self, weights, arch, mm_dtype):
    return (self.pack_bf16(weights, arch) if mm_dtype == "bfloat16"
            else weights)


def version(label, directory):
    from shapeclipper_torch.ops.fused_sdf import GenericSdfKernel
    paths = [os.path.join(directory, f) for f in FILES]
    attrs = dict(stem=f"generic_ab_{label}", source=paths[0],
                 extra_sources=(paths[1],), headers=(paths[2],))
    with open(paths[0]) as f:
        text = f.read()
    if "scl_sdf_generic_pack_tf32" not in text:
        attrs.update(_bind=_bind_fma, _weights=_weights_fma,
                     _launch_key=_key_mma_sync)
    elif "scl_sdf_generic_fwd_form" not in text:
        attrs.update(_bind=_bind_mma_sync, _launch_key=_key_mma_sync)
    return type(f"Version_{label}", (GenericSdfKernel,), attrs)(OUT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--ablate", action="append", default=[],
                    choices=sorted(ABLATIONS))
    ap.add_argument("--mm", default="bfloat16", choices=("bfloat16",
                                                          "float32"),
                    help="the products' form to time (default bfloat16)")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="BxN", help="batch rows x points (default "
                    "12x1024 and 24x32768)")
    args = ap.parse_args()
    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shape] \
        or [(12, 1024), (24, 32768)]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {}
    for spec in args.build:
        label, directory = spec.split("=", 1)
        builds[label] = version(label, directory)
    for name in args.ablate:
        builds[name] = version(name, ablated(name, os.path.join(
            OUT, "src", name)))
    if not builds:
        raise SystemExit("give at least one --build or --ablate")
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda g: g.build(force=True), builds.values()))
    for label, g in builds.items():
        for entry in g.ptxas_log.split("Compiling entry function")[1:]:
            head = entry.split("\n")[0]
            m = re.search(r"sdf_generic_(\w+?_kernel\w{0,8})", head)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            if m and regs and spill:
                print(f"{label} {m.group(1)}: {regs.group(1)} registers, "
                      f"{spill.group(1)} / {spill.group(2)} bytes spill "
                      "stores / loads", flush=True)
    mm = args.mm
    sfx, tag = ("_bf16", "-bf16") if mm == "bfloat16" else ("", "")
    results = {label: [] for label in builds}
    for B, N in shapes:
        c = cs.generic_case(cs.GENERIC_WIDE, B, N, cs.SEED + 19)
        big = N > 2000
        ref = fref = sref = None
        if not big:
            ref = cs.generic_backward_plain(c, mm, torch.float64, 1,
                                            cs.GENERIC_F64_POINTS)
            fref = cs.generic_forward_plain(c, True, "float32")
        if B * N >= 100000 and B * N * c.arch.width <= 2 ** 27:
            sref = cs.generic_forward_plain(c, True, mm)
        order = list(builds.items())
        for rnd, items in enumerate((order, order[::-1])):
            for label, g in items:
                with torch.inference_mode():
                    k8 = cs.cuda_ms(lambda: g.forward(
                        c.pts, c.w, c.b, c.arch, True, c.sym, mm),
                        runs=1, warmup=1, calls=3 if big else 20)
                    k8n = cs.cuda_ms(lambda: g.forward(
                        c.pts, c.w, c.b, c.arch, False, c.sym, mm),
                        runs=1, warmup=1, calls=3 if big else 20)
                k9 = cs.cuda_ms(lambda: g.backward(
                    c.pts, c.w, c.b, c.arch, *c.cots, c.sym, mm),
                    runs=1, warmup=1, calls=2 if big else 20)
                row = {"B": B, "N": N, "round": rnd, f"k8{sfx}": k8,
                       f"k8_nograd{sfx}": k8n, f"k9{sfx}": k9}
                line = (f"{label} {B} x {N} round {rnd}: K8{tag} {k8:.3f}, "
                        f"K8-nograd{tag} {k8n:.3f}, K9{tag} {k9:.3f} ms")
                if ref is not None and rnd == 0:
                    got = g.backward(c.pts, c.w, c.b, c.arch, *c.cots, c.sym,
                                     mm)
                    row["k9_err"] = [float((a.double() - r).abs().max()
                                           / r.abs().max())
                                     for a, r in zip(got, ref)]
                    with torch.inference_mode():
                        out = g.forward(c.pts, c.w, c.b, c.arch, True, c.sym,
                                        mm)
                    row["k8_err"] = [float((a - r).abs().max())
                                     for a, r in zip(out, fref)]
                    line += (f"; K9{tag} max err / max|ref| " + " ".join(
                        f"{e:.2e}" for e in row["k9_err"])
                        + f"; K8{tag} max abs err (sdf, feat, grad) against "
                        "float32 " + " ".join(f"{e:.2e}"
                                              for e in row["k8_err"]))
                if sref is not None and rnd == 0:
                    with torch.inference_mode():
                        out = g.forward(c.pts, c.w, c.b, c.arch, True, c.sym,
                                        mm)
                    row["k8_plain_err"] = [
                        (float((a - r).abs().max()), float((a - r).abs()
                                                           .mean()))
                        for a, r in zip(out, sref)]
                    line += (f"; K8{tag} against its plain version, max / "
                             "mean (sdf, feat, grad) " + " ".join(
                                 f"{m:.2e}/{e:.2e}"
                                 for m, e in row["k8_plain_err"]))
                    del out
                print(line, flush=True)
                results[label].append(row)
        del c, ref, fref, sref
        torch.cuda.empty_cache()
    print(f"card {cs.card_line()}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
