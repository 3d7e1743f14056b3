#!/usr/bin/env python3
"""Where a fused SDF kernel's time goes inside a block, on one NVIDIA GPU.

    python scripts/sdf_segments.py --kernel fwd [--B 12] [--N 32768]
        [--no-grad] [--source FILE]
    python scripts/sdf_segments.py --kernel fwd-bf16 [--no-grad] [--source FILE]
    python scripts/sdf_segments.py --kernel bwd [--B 12] [--N 32768]
    python scripts/sdf_segments.py --kernel bwd-bf16 [--B 12] [--N 32768]

Builds the forward (`shapeclipper_torch/csrc/fused_sdf_fwd.cu`, K1 / K3),
the backward (`fused_sdf_bwd.cu`, K2) or its bf16 kernel
(`fused_sdf_bwd_bf16.cu`, K2-bf16, linked with the entry point of
`fused_sdf_bwd.cu`) once more, or another version of it
given by `--source` (an earlier design, say), into `build/sdf_segments/`,
with a clock64() read after every __syncthreads() from the top of the
source's namespace to the end of the main kernel (so barriers in helper
functions count too): thread 0 of block 0 adds the cycles since its
previous read to the counter of the barrier that ends the segment (segments
inside the tile loop sum over tiles, and those in helpers over calls).

`fwd-bf16` (K1-bf16 / K3-bf16, `fused_sdf_fwd_bf16_kernel`) has no block
barrier in its tile loop; its stage boundaries are the source's own
`SCL_SEGMENT(i)` marks (empty unless this script defines them), read by
warp 0 of block 0 (thread 0) and summed over its tiles, with the names of
`FWD_BF16_SEGMENTS`. A source without marks (the first tensor-core design,
which staged the weights in every block) gets them inserted at the stage
boundaries of `FIRST_FWD_BF16_MARKS`.

One launch at B x N (default: the flagship render shape) is timed by CUDA
events, then one instrumented launch prints each segment's cycles, its share
and the source line of the barrier that ends it (or the mark's stage). The
instrumented build is only for this breakdown; the port never loads it.
Imports no JAX.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "shapeclipper_torch", "csrc")
KERNELS = {"fwd": ("fused_sdf_fwd.cu", "fused_sdf_fwd_kernel("),
           "fwd-bf16": ("fused_sdf_fwd.cu", "fused_sdf_fwd_bf16_kernel("),
           "bwd": ("fused_sdf_bwd.cu", "fused_sdf_bwd_kernel("),
           "bwd-bf16": ("fused_sdf_bwd_bf16.cu",
                        "fused_sdf_bwd_bf16_kernel(")}
OUT = os.path.join(REPO, "build", "sdf_segments")
MAX_SEGMENTS = 64
# fwd-bf16's stages, by the index its SCL_SEGMENT marks add to
FWD_BF16_SEGMENTS = (("weights staged", "posenc")
                     + tuple(f"layer {l} products" for l in range(5))
                     + tuple(f"layer {l} activation" for l in range(5))
                     + ("output layer",))
# (text of an anchor line, mark inserted on a line of its own before it) in
# the first tensor-core design of fused_sdf_fwd_bf16_kernel (commit
# 9e178fe), which has no marks; each anchor is searched after the previous
# one, and the output layer's mark also goes before the end of the kernel
FIRST_FWD_BF16_MARKS = (
    ("const int lane = threadIdx.x % 32;", "SCL_SEGMENT(0);"),
    ("const int b = tile / tiles_per_batch;", "SCL_SEGMENT(12);"),
    ("// ---- hidden layers 0..4", "SCL_SEGMENT(1);"),
    ("if (l > 0) {", "if (l > 0) SCL_SEGMENT(6 + l);"),
    ("// bias and activation; the next layer's A fragments",
     "SCL_SEGMENT(2 + l);"),
    ("// ---- output layer", "SCL_SEGMENT(11);"),
)
FWD_BF16_MARK_END = "SCL_SEGMENT(12);\n"


def _kernel_body(src, kernel, begin):
    """(first, end) offsets of the body of `kernel` after `begin`: just
    past its opening brace, and just past its closing one."""
    start = src.index(kernel, src.index("__global__", begin))
    body = src.index("{", src.index(")", start)) + 1
    depth, end = 1, body
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    return body, end


def insert_marks(src, kernel):
    """`src` with FIRST_FWD_BF16_MARKS inserted into the body of `kernel`
    (a source without SCL_SEGMENT marks)."""
    body, end = _kernel_body(src, kernel, src.index("namespace {"))
    out, pos = [src[:body]], body
    for anchor, mark in FIRST_FWD_BF16_MARKS:
        at = src.index(anchor, pos)
        if at >= end:
            raise RuntimeError(f"anchor {anchor!r} not in the kernel")
        line = src.rindex("\n", 0, at) + 1
        out += [src[pos:line], mark + "\n"]
        pos = line
    close = src.rindex("}", 0, end)
    out += [src[pos:close], FWD_BF16_MARK_END, src[close:]]
    return "".join(out)


def instrument(src, kernel):
    """-> (instrumented source, [source line of each barrier]) for the
    barriers between `namespace {` and the end of the body of `kernel`;
    for a kernel with SCL_SEGMENT marks (fwd-bf16) the marks alone, and
    [] for the lines."""
    begin = src.index("namespace {")
    body, end = _kernel_body(src, kernel, begin)
    marked = "SCL_SEGMENT(" in src[body:end]
    lines, pieces, last = [], [], begin
    for m in re.finditer(r"__syncthreads\(\);", src[begin:end]):
        if marked:
            break
        pos = begin + m.end()
        lines.append(src.count("\n", 0, pos) + 1)
        pieces += [src[last:pos], f" SCL_SEGMENT({len(lines) - 1});"]
        last = pos
    if not marked and (not lines or len(lines) > MAX_SEGMENTS):
        raise RuntimeError(f"{len(lines)} barriers in the kernel")
    head = (f"__device__ unsigned long long scl_segments[{MAX_SEGMENTS}];\n"
            "__device__ unsigned long long scl_last_;\n"
            "#define SCL_IS_TIMER (threadIdx.x == 0 && blockIdx.x == 0)\n"
            "#undef SCL_SEGMENT\n"
            "#define SCL_SEGMENT(i) if (SCL_IS_TIMER)"
            " { const unsigned long long now_ = clock64();"
            " scl_segments[i] += now_ - scl_last_; scl_last_ = now_; }\n")
    out = src[:begin] + head + "".join(pieces) + src[last:]
    # the timer starts when the main kernel starts
    open_brace = out.index("{", out.index(")", out.index(
        kernel, out.index("__global__", begin + len(head))))) + 1
    out = (out[:open_brace] + "\n  if (SCL_IS_TIMER) scl_last_ = clock64();"
           + out[open_brace:])
    out += ('\nextern "C" int scl_segments_read(void* out, int reset) {\n'
            f"  static unsigned long long zero[{MAX_SEGMENTS}];\n"
            "  return reset ? (int)cudaMemcpyToSymbol(scl_segments, zero,\n"
            "                                        sizeof(zero))\n"
            "               : (int)cudaMemcpyFromSymbol(out, scl_segments,\n"
            "                                          sizeof(zero));\n}\n")
    return out, lines


def build(src, name, extra=()):
    """Compile the instrumented source, with `extra` sources linked into the
    same library, and load it."""
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{name}_segments.cu")
    so = os.path.join(OUT, f"lib{name}_segments.so")
    with open(cu, "w") as f:
        f.write(src)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, cu, *extra], check=True)
    return ctypes.CDLL(so)


def launcher(kind, lib, net, B, N, grad, dev, has_mm, packs=False):
    """-> a function that launches the instrumented kernel once (the
    float32 products, or the bf16 ones for `fwd-bf16` and `bwd-bf16`;
    `has_mm`: the source's entry takes `mm_bf16`, which earlier sources
    lack; `packs`: its bf16 forward reads the weights in fragment order,
    written by its `scl_fused_sdf_pack_bf16`, where earlier ones read the
    plain bf16 copy)."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
    lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
    with torch.no_grad():
        weights, bias = F.pack_fused_params(*F.prepare_fused_params(net, lat))
    bf16 = kind in ("fwd-bf16", "bwd-bf16")
    mm = (int(bf16),) if has_mm else ()
    f32 = dict(device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "fwd-bf16":
        if packs:
            pack = lib.scl_fused_sdf_pack_bf16
            pack.argtypes = [ctypes.c_void_p] * 4
            frag = torch.empty(F.BF16_FRAG_ELEMS, device=dev,
                               dtype=torch.bfloat16)
            plain = torch.empty(F.NUM_WEIGHTS, device=dev,
                                dtype=torch.bfloat16)
            if pack(weights.data_ptr(), frag.data_ptr(), plain.data_ptr(),
                    stream):
                raise RuntimeError("the weight pack failed")
            weights = frag
        else:
            weights = weights.to(torch.bfloat16)
    if kind in ("fwd", "fwd-bf16"):
        fn = lib.scl_fused_sdf_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * (4 + len(mm)) \
            + [ctypes.c_void_p]
        bufs = [pts, weights, bias, torch.empty(B, N, **f32),
                torch.empty(B, N, 64, **f32), torch.empty(B, N, 3, **f32)]
        args = (B, N, int(grad), 1, *mm, stream)
    else:
        fn = lib.scl_fused_sdf_bwd
        fn.argtypes = [ctypes.c_void_p] * 12 \
            + [ctypes.c_int] * (4 + len(mm)) + [ctypes.c_void_p]
        cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]
        tile = F.BWD_TILE_POINTS_BF16 if bf16 else F.BWD_TILE_POINTS
        grid = min(torch.cuda.get_device_properties(dev).multi_processor_count,
                   B * -(-N // tile))
        if bf16:
            weights = weights.to(torch.bfloat16)
        bufs = [pts, weights, bias, cots[0][..., 0].contiguous(), cots[1],
                cots[2], torch.empty(B, N, 3, **f32),
                torch.empty(F.NUM_WEIGHTS, **f32),
                torch.empty(B, F.BIAS_WIDTH, **f32),
                torch.empty(grid, F.NUM_WEIGHTS, **f32),
                torch.empty(grid, B, F.BIAS_WIDTH, **f32),
                torch.empty(grid, F.BWD_STASH_FLOATS_BF16 if bf16
                            else F.BWD_STASH_FLOATS, **f32)]
        args = (B, N, grid, 1, *mm, stream)

    def launch():
        err = fn(*[b.data_ptr() for b in bufs], *args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return launch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="bwd")
    ap.add_argument("--source", help="the .cu file to instrument (default: "
                    "the repository's source of --kernel)")
    ap.add_argument("--label", default=None, help="name of the build")
    ap.add_argument("--B", type=int, default=12)
    ap.add_argument("--N", type=int, default=32768)
    ap.add_argument("--no-grad", action="store_true",
                    help="the forward without tangents (K3)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sdf_segments.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from shapeclipper_torch.models.implicit import SDFNetwork

    file, kernel = KERNELS[args.kernel]
    source = args.source or os.path.join(CSRC, file)
    with open(source) as f:
        text = f.read()
    if args.kernel == "fwd-bf16" and "SCL_SEGMENT(" not in text:
        text = insert_marks(text, kernel)
    src, lines = instrument(text, kernel)
    label = args.label or args.kernel
    # the backward's entry point also launches the bf16 kernel of its own
    # file, linked as it is, and the bf16 kernel is launched through it
    if args.kernel == "bwd-bf16":
        extra = (os.path.join(CSRC, "fused_sdf_bwd.cu"),)
    elif "scl_fused_sdf_bwd_bf16_launch" in text:
        extra = (os.path.join(CSRC, "fused_sdf_bwd_bf16.cu"),)
    else:
        extra = ()
    lib = build(src, label, extra)
    lib.scl_segments_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    dev = torch.device("cuda")
    net = SDFNetwork(geometric_init=False,
                     generator=torch.Generator().manual_seed(0)).to(dev)
    B, N = args.B, args.N
    launch = launcher(args.kernel, lib, net, B, N, not args.no_grad, dev,
                      "int mm_bf16" in text or args.kernel == "bwd-bf16",
                      "scl_fused_sdf_pack_bf16" in text)
    launch()
    torch.cuda.synchronize()
    if lib.scl_segments_read(None, 1):
        raise RuntimeError("could not reset the counters")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    cycles = (ctypes.c_ulonglong * MAX_SEGMENTS)()
    if lib.scl_segments_read(ctypes.addressof(cycles), 0):
        raise RuntimeError("could not read the counters")
    names = ([f"{os.path.basename(source)}:{line}" for line in lines]
             or list(FWD_BF16_SEGMENTS))
    total = sum(cycles[:len(names)])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    what = f"{args.kernel}{' (no tangents)' if args.no_grad else ''}"
    print(f"{label}: {what} instrumented at B={B} N={N}: "
          f"{start.elapsed_time(end):.4f} ms; block 0: {total} cycles; {card}")
    for i, name in enumerate(names):
        print(f"  segment {'ending at ' if lines else ''}{name}: {cycles[i]} "
              f"cycles ({100 * cycles[i] / max(total, 1):.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
