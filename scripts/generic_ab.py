#!/usr/bin/env python3
"""Time versions of the generic fused SDF pair's bf16 forms (K8-bf16,
K8-nograd-bf16 and K9-bf16 of `csrc/fused_sdf_generic_bf16.cu`) against
each other on one NVIDIA GPU, at the wide SDF MLP (`chip_smoke.GENERIC_WIDE`,
VolSDF's 8 x 256 with a skip at layer 4) at the eikonal's 12 x 1,024 and
the merged render's 24 x 32,768.

    mkdir -p build/v/old
    for f in fused_sdf_generic.cu fused_sdf_generic_bf16.cu fused_sdf_generic.cuh
    do git show <commit>:shapeclipper_torch/csrc/$f > build/v/old/$f; done
    python scripts/generic_ab.py --build new=shapeclipper_torch/csrc \\
        --build old=build/v/old [--ablate nostash ...]

Each `--build LABEL=DIR` names a directory that holds the library's three
sources under their repository names; `--ablate NAME` adds a build of the
repository's sources with one part of the bf16 kernels cut out (its results
are wrong: it times what is left; `ABLATIONS` says what each cuts). All are
compiled by nvcc for sm_90a at once (`ops/cuda_lib.py::CudaLibrary.build`)
into `build/generic_ab/`; each build's registers and spills of its bf16
kernels are printed from ptxas. At 12 x 1,024 every build's K9-bf16 is held
against the float64 bf16 plain version (`chip_smoke.generic_backward_plain`;
the largest error over max|ref| of each gradient is printed). Each shape
times the builds in two rounds, in order and then in reverse (a, b, b, a):
K8-bf16 and K8-nograd-bf16 over 20 launches (3 at 24 x 32,768) and K9-bf16
over 20 (2) between two CUDA events, its bf16 pack included. Prints one
line a build and round and the card, then one JSON line of the results.
Imports no JAX.
"""

import argparse
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


def version(label, directory):
    from shapeclipper_torch.ops.fused_sdf import GenericSdfKernel
    paths = [os.path.join(directory, f) for f in FILES]
    cls = type(f"Version_{label}", (GenericSdfKernel,), dict(
        stem=f"generic_ab_{label}", source=paths[0],
        extra_sources=(paths[1],), headers=(paths[2],)))
    return cls(OUT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--ablate", action="append", default=[],
                    choices=sorted(ABLATIONS))
    args = ap.parse_args()
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
            m = re.search(r"sdf_generic_(\w+?_bf16_kernel\w{0,8})", head)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            if m and regs and spill:
                print(f"{label} {m.group(1)}: {regs.group(1)} registers, "
                      f"{spill.group(1)} / {spill.group(2)} bytes spill "
                      "stores / loads", flush=True)
    results = {label: [] for label in builds}
    for B, N in ((12, 1024), (24, 32768)):
        c = cs.generic_case(cs.GENERIC_WIDE, B, N, cs.SEED + 19)
        big = N > 2000
        ref = None if big else cs.generic_backward_plain(
            c, "bfloat16", torch.float64, 1, cs.GENERIC_F64_POINTS)
        order = list(builds.items())
        for rnd, items in enumerate((order, order[::-1])):
            for label, g in items:
                with torch.inference_mode():
                    k8 = cs.cuda_ms(lambda: g.forward(
                        c.pts, c.w, c.b, c.arch, True, c.sym, "bfloat16"),
                        runs=1, warmup=1, calls=3 if big else 20)
                    k8n = cs.cuda_ms(lambda: g.forward(
                        c.pts, c.w, c.b, c.arch, False, c.sym, "bfloat16"),
                        runs=1, warmup=1, calls=3 if big else 20)
                k9 = cs.cuda_ms(lambda: g.backward(
                    c.pts, c.w, c.b, c.arch, *c.cots, c.sym, "bfloat16"),
                    runs=1, warmup=1, calls=2 if big else 20)
                row = dict(B=B, N=N, round=rnd, k8_bf16=k8,
                           k8_nograd_bf16=k8n, k9_bf16=k9)
                line = (f"{label} {B} x {N} round {rnd}: K8-bf16 {k8:.3f}, "
                        f"K8-nograd-bf16 {k8n:.3f}, K9-bf16 {k9:.3f} ms")
                if ref is not None and rnd == 0:
                    got = g.backward(c.pts, c.w, c.b, c.arch, *c.cots, c.sym,
                                     "bfloat16")
                    row["k9_err"] = [float((a.double() - r).abs().max()
                                           / r.abs().max())
                                     for a, r in zip(got, ref)]
                    line += "; K9-bf16 max err / max|ref| " + " ".join(
                        f"{e:.2e}" for e in row["k9_err"])
                print(line, flush=True)
                results[label].append(row)
        del c, ref
        torch.cuda.empty_cache()
    print(f"card {cs.card_line()}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
