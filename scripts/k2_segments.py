#!/usr/bin/env python3
"""Where K2's time goes inside a block, on one NVIDIA GPU.

    python scripts/k2_segments.py [--B 12] [--N 32768]

Builds `shapeclipper_torch/csrc/fused_sdf_bwd.cu` once more, into
`build/k2_segments/`, with a clock64() read after every __syncthreads() of
the main kernel: thread 0 of block 0 adds the cycles since its previous read
to the counter of the barrier that ends the segment (segments inside the
tile loop sum over tiles and layers). One launch at B x N (default: the
flagship render shape) is timed by CUDA events, then one instrumented launch
prints each segment's cycles, its share and the source line of the barrier
that ends it. The instrumented build is only for this breakdown; the port
never loads it. Imports no JAX.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "shapeclipper_torch", "csrc", "fused_sdf_bwd.cu")
OUT = os.path.join(REPO, "build", "k2_segments")
KERNEL = "fused_sdf_bwd_kernel("
MAX_SEGMENTS = 64


def instrument(src):
    """-> (instrumented source, [source line of each barrier])."""
    start = src.index("__global__")
    start = src.index(KERNEL, start)
    body = src.index("{", src.index(")", start)) + 1
    depth, end = 1, body
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    lines, pieces, last = [], [], body
    for m in re.finditer(r"__syncthreads\(\);", src[body:end]):
        pos = body + m.end()
        lines.append(src.count("\n", 0, pos) + 1)
        pieces += [src[last:pos], f" SCL_SEGMENT({len(lines) - 1});"]
        last = pos
    if not lines or len(lines) > MAX_SEGMENTS:
        raise RuntimeError(f"{len(lines)} barriers in the kernel")
    head = (f"__device__ unsigned long long scl_segments[{MAX_SEGMENTS}];\n"
            "#define SCL_SEGMENT(i) if (threadIdx.x == 0 && blockIdx.x == 0)"
            " { const unsigned long long now_ = clock64();"
            " scl_segments[i] += now_ - scl_last_; scl_last_ = now_; }\n")
    out = (src[:body] + "\n  unsigned long long scl_last_ = clock64();"
           + "".join(pieces) + src[last:])
    out = out.replace("namespace {", head + "namespace {", 1)
    out += ('\nextern "C" int scl_segments_read(void* out, int reset) {\n'
            f"  static unsigned long long zero[{MAX_SEGMENTS}];\n"
            "  return reset ? (int)cudaMemcpyToSymbol(scl_segments, zero,\n"
            "                                        sizeof(zero))\n"
            "               : (int)cudaMemcpyFromSymbol(out, scl_segments,\n"
            "                                          sizeof(zero));\n}\n")
    return out, lines


def build(src):
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "fused_sdf_bwd_segments.cu")
    so = os.path.join(OUT, "libfused_sdf_bwd_segments.so")
    with open(cu, "w") as f:
        f.write(src)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, cu], check=True)
    return ctypes.CDLL(so)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--B", type=int, default=12)
    ap.add_argument("--N", type=int, default=32768)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k2_segments.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from shapeclipper_torch.models.implicit import SDFNetwork
    from shapeclipper_torch.ops import fused_sdf as F

    with open(SOURCE) as f:
        src, lines = instrument(f.read())
    lib = build(src)
    fn = lib.scl_fused_sdf_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.scl_segments_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)
    B, N = args.B, args.N
    pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
    lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
    cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]
    with torch.no_grad():
        weights, bias = F.pack_fused_params(*F.prepare_fused_params(net, lat))
    grid = min(torch.cuda.get_device_properties(dev).multi_processor_count,
               B * -(-N // F.BWD_TILE_POINTS))
    f32 = dict(device=dev, dtype=torch.float32)
    bufs = [pts, weights, bias, cots[0][..., 0].contiguous(), cots[1],
            cots[2], torch.empty(B, N, 3, **f32),
            torch.empty(F.NUM_WEIGHTS, **f32),
            torch.empty(B, F.BIAS_WIDTH, **f32),
            torch.empty(grid, F.NUM_WEIGHTS, **f32),
            torch.empty(grid, B, F.BIAS_WIDTH, **f32),
            torch.empty(grid, F.BWD_STASH_FLOATS, **f32)]

    def launch():
        err = fn(*[b.data_ptr() for b in bufs], B, N, grid, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

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
    total = sum(cycles[:len(lines)])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"K2 (instrumented) at B={B} N={N}, grid {grid}: "
          f"{start.elapsed_time(end):.4f} ms; block 0: {total} cycles; {card}")
    for i, line in enumerate(lines):
        print(f"  segment ending at fused_sdf_bwd.cu:{line}: {cycles[i]} "
              f"cycles ({100 * cycles[i] / total:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
