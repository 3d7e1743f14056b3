"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output (`correct`, `attempted`, `failed`, `metrics`, `device`,
with --trace 1 `breakdown`, and last `checks`: each number compared with
its limit); everything else goes to standard error. Exits non-zero with no
result when CUDA is absent or has fewer cards than the cell asks for, and
when a module of JAX or of the JAX package is loaded."""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX, its libraries and the JAX package, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "shapeclipper_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program builds its kernels into `build/` inside the checkout
    sys.path.insert(0, REPO)
    import torch
    from benchmark.harness import main as harness
    from benchmark.harness import spec
    chips = spec.Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
