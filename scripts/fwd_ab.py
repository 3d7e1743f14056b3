#!/usr/bin/env python3
"""Time versions of the fused SDF forward (K1 with tangents, K3 without)
against each other on one NVIDIA GPU, at the shapes the port's paths give it.

    git show <commit>:shapeclipper_torch/csrc/fused_sdf_fwd.cu > build/old.cu
    python scripts/fwd_ab.py --build new=shapeclipper_torch/csrc/fused_sdf_fwd.cu \
        --build old=build/old.cu [--bf16]

Each `--build LABEL=SOURCE` is compiled by nvcc for sm_90a (all at once,
through `ops/cuda_lib.py::CudaLibrary.build`) into `build/fwd_ab/`; every
source must export the C entry `scl_fused_sdf_fwd` of
`csrc/fused_sdf_fwd.cu`. At each
of `chip_smoke.py`'s phase-2 shapes (`forward_cases`: K1 at the serving
render's 1 x 262,144 and the training render's 12 x 32,768, K3 at vox 64 and
vox 100), every build is held against the plain PyTorch version
(`chip_smoke.check_forward`) and then timed by CUDA events (`cuda_ms`) in
two rounds, the builds in order and then in reverse (a, b, c, c, b, a),
each time `chip_smoke.SDF_TIMED_CALLS` launches between two events.
Prints each build's registers and spills, times, their mean, the share of
the bound (`chip_smoke.forward_bound`) and whether its outputs are bitwise
the first build's, then one JSON line of the results.
`--bf16` runs the bfloat16-product instantiations instead (sources whose
entry takes `mm_bf16`), held against the plain version's bf16 products as
`chip_smoke.py` holds them (`check_bf16`); each version reads its weights
as its source does (the fragments of its own `scl_fused_sdf_pack_bf16`, or
the plain bf16 copy of earlier sources), made once before it is timed.
Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

OUT = os.path.join(REPO, "build", "fwd_ab")


def version_class():
    import torch
    from shapeclipper_torch.ops.fused_sdf import FusedSdfKernel

    class Version(FusedSdfKernel):
        """One version of the forward's source, launched through the port's
        wrapper and bound by its C entry alone (an earlier design need not
        export the port's layout and tile checks)."""

        stem = "fwd_ab"

        def __init__(self, source):
            super().__init__(OUT)
            self.source = source
            with open(source) as f:
                text = f.read()
            self.has_mm = "int mm_bf16" in text
            # its bf16 kernel reads the fragments of its own weight pack,
            # where earlier ones read the plain bf16 copy
            self.packs = "scl_fused_sdf_pack_bf16" in text

        def _bind(self, lib):
            fn = lib.scl_fused_sdf_fwd
            fn.argtypes = ([ctypes.c_void_p] * 6
                           + [ctypes.c_int] * (5 if self.has_mm else 4)
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            if self.packs:
                lib.scl_fused_sdf_pack_bf16.argtypes = [ctypes.c_void_p] * 4
                lib.scl_fused_sdf_pack_bf16.restype = ctypes.c_int

        def bf16_weights(self, weights):
            """What this version's bf16 kernel reads, made from the float32
            weights before it is timed."""
            if self.packs:
                return self.pack_bf16(weights)[0]
            return weights.to(torch.bfloat16)

        def _bf16_weights(self, weights):
            if self.packs:
                return super()._bf16_weights(weights)
            return weights.to(torch.bfloat16) \
                if weights.dtype == torch.float32 else weights

        def build(self, force=False):
            lib = super().build(force)
            if self.has_mm:
                return lib
            # an earlier source: float32 products only, no mm_bf16 argument
            fn = lib.scl_fused_sdf_fwd

            class Entry:
                @staticmethod
                def scl_fused_sdf_fwd(*a):
                    if a[10]:
                        raise ValueError("this source has no bf16 products")
                    return fn(*a[:10], a[11])
            self.lib = Entry
            return Entry

        def usage(self, compute_grad, bf16):
            """ptxas's (registers, spill stores, spill loads) of an
            instantiation."""
            name = "fused_sdf_fwd_bf16_kernel" if bf16 else \
                "fused_sdf_fwd_kernel"
            return cs.ptxas_usage(self.ptxas_log,
                                  f"{name}ILb{int(compute_grad)}E")

    return Version


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build", action="append", required=True,
                    help="LABEL=SOURCE")
    ap.add_argument("--bf16", action="store_true",
                    help="the bfloat16-product instantiations")
    args = ap.parse_args(argv)
    mm = "bfloat16" if args.bf16 else "float32"
    import torch
    if not torch.cuda.is_available():
        print("fwd_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from shapeclipper_torch.ops import fused_sdf as F

    Version = version_class()
    labels, versions = [], []
    for spec in args.build:
        label, source = spec.split("=", 1)
        labels.append(label)
        versions.append(Version(os.path.join(REPO, source)))
    with ThreadPoolExecutor(len(versions)) as pool:
        for done in [pool.submit(v.build, True) for v in versions]:
            done.result()
    card = cs.card_line()
    print(f"card: {card}")
    for label, v in zip(labels, versions):
        for what, cg in (("K1", True), ("K3", False)):
            regs, st, ld = v.usage(cg, args.bf16)
            print(f"[{label}] ptxas {what}: {regs} registers, {st}/{ld} "
                  "bytes spilled")

    dev = torch.device("cuda")
    net, cases = cs.forward_cases(cs.load_opt(), dev)
    results = {}
    with torch.inference_mode():
        for _, cg, pts, lat in cases:
            B, N = pts.shape[:2]
            name = f"{'K1' if cg else 'K3'} {B} x {N:,}"
            weights, bias = F.pack_fused_params(
                *F.prepare_fused_params(net, lat))
            want = F.fused_sdf_forward_reference(net, pts, lat, cg, mm)
            w_mm = {label: v.bf16_weights(weights) if args.bf16 else weights
                    for label, v in zip(labels, versions)}

            def run(v, label, mm=mm, w=None):
                sdf, feat, grad = v.launch(pts, w_mm[label] if w is None
                                           else w, bias, cg, True, mm)
                return sdf[..., None], feat, grad

            errs, same = {}, {}
            parts = ("sdf", "feat", "grad")[:3 if cg else 2]
            for label, v in zip(labels, versions):
                got = run(v, label)
                torch.cuda.synchronize()
                if label == labels[0]:
                    first = got
                same[label] = all(torch.equal(x, y) for x, y in
                                  zip(got[:len(parts)], first[:len(parts)]))
                where = f"({label} at {name})"
                if args.bf16:   # chip_smoke.py's two-fold bf16 check
                    f32 = run(v, label, "float32", weights)
                    errs[label] = {p: e[0] for p, e in cs.check_bf16(
                        dict(zip(parts, got)), dict(zip(parts, want)),
                        dict(zip(parts, f32)), where, cs.BF16_MAX_TOL,
                        cs.BF16_MEAN_TOL).items()}
                else:
                    errs[label] = cs.check_forward(got, want, where)
            times = {label: [] for label in labels}
            order = list(zip(labels, versions))
            for rnd in (order, order[::-1]):
                for label, v in rnd:
                    times[label].append(cs.cuda_ms(
                        lambda: run(v, label), calls=cs.SDF_TIMED_CALLS))
            _, (bound_ms, bound_by) = cs.forward_bound(B, N, cg, args.bf16)
            print(f"{name}: bound {bound_ms:.4f} ms ({bound_by})")
            results[name] = {"bound_ms": bound_ms}
            for label in labels:
                ms = sum(times[label]) / 2
                print(f"  [{label}] {times[label][0]:.4f} / "
                      f"{times[label][1]:.4f} ms (mean {ms:.4f}; "
                      f"{100 * bound_ms / ms:.1f}% of the bound); max abs err "
                      + ", ".join(f"{p} {e:.3e}" for p, e in
                                  errs[label].items())
                      + ("; bitwise " if same[label] else "; not bitwise ")
                      + f"[{labels[0]}]")
                results[name][label] = dict(ms=times[label], err=errs[label],
                                            bitwise_first=same[label])
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
