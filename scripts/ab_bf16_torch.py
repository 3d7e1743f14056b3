#!/usr/bin/env python3
"""Convergence A/B of the PyTorch port's precision on one NVIDIA GPU:
float32 against the flagship's bfloat16 (`tpu.encoder_dtype` and
`tpu.implicit_dtype`), over several seeds.

    python scripts/ab_bf16_torch.py [--steps 300] [--seeds 3]
        [--out build/ab_bf16_torch.json]

Each run is scripts/validate_training.py's set-up on the port
(options/synthetic/config.yaml, batch 8, 64 x 64, 256 rays x 32 samples,
evaluation at vox 32 / 8,192 points): `Runner.evaluate` on the training
evaluation before and after `--steps` steps through the loader. Both arms
run in one process, float32 (both keys float32) then bfloat16 (both keys
bfloat16, the YAML's own), seeds 0 .. n-1 each; the seed sets the
initialisation, the loader's order and the step's draws. Writes a JSON of
the runs (loss over the first and last 10 steps, the Chamfer distance
before and after, steps per second) with each arm's mean, the card's name
and power limit; the counterpart of the JAX package's scripts/ab_bf16.py
(output/ab_bf16.json), which varied `tpu.implicit_dtype` alone. Imports no
JAX; needs the card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(steps, seed, dtype):
    import numpy as np
    import torch
    from shapeclipper_torch.config import options
    from shapeclipper_torch.train.trainer import Runner, batch_to_var

    opt = options.load_options(os.path.join(REPO, "options", "synthetic",
                                            "config.yaml"))
    opt.update(name=f"ab_{dtype}_s{seed}", seed=seed, resume=False,
               load=None, tb=None, batch_size=8, image_size=[64, 64],
               max_epoch=10 ** 6)
    opt.H, opt.W = opt.image_size
    opt.tpu.update(encoder_dtype=dtype, implicit_dtype=dtype)
    opt.data.update(max_img_cat=32, num_workers=2)
    opt.render.update(rand_sample=256, n_samples_uniform=32)
    opt.eval.update(batch_size=2, image_size=[32, 32], vox_res=32,
                    num_points=8192, n_vis=1)
    opt.freq.update(scalar=10 ** 6, vis=10 ** 6, save_vis=10 ** 6,
                    ckpt_latest=10 ** 6, eval=10 ** 6)
    opt.output_path = os.path.join(REPO, "build", "ab_bf16_torch",
                                   opt.name)
    runner = Runner(opt, "cuda")
    runner.load_dataset(opt)
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    cd_init = runner.evaluate(opt, ep=0, training=True)
    losses, epoch = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(losses) < steps:
        runner.train_loader.set_epoch(epoch)
        for batch in runner.train_loader:
            loss = runner.train_iteration(opt,
                                          batch_to_var(batch, runner.device))
            losses.append(float(loss.all))
            if len(losses) >= steps:
                break
        epoch += 1
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cd_final = runner.evaluate(opt, ep=1, training=True)
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"{dtype} seed {seed}: a loss is not finite")
    return dict(steps=steps, seed=seed, dtype=dtype,
                loss_first10=float(np.mean(losses[:10])),
                loss_last10=float(np.mean(losses[-10:])),
                cd_init=float(cd_init), cd_final=float(cd_final),
                it_per_sec=steps / seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "ab_bf16_torch.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_bf16_torch.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    runs = []
    for dtype in ("float32", "bfloat16"):
        for seed in range(args.seeds):
            runs.append(run_one(args.steps, seed, dtype))
            print(json.dumps(runs[-1]), flush=True)
    summary = {"card": card, "runs": runs}
    for dtype in ("float32", "bfloat16"):
        rows = [r for r in runs if r["dtype"] == dtype]
        summary[dtype] = {k: sum(r[k] for r in rows) / len(rows) for k in
                          ("loss_last10", "cd_final", "it_per_sec")}
        summary[dtype]["cd_final_range"] = [min(r["cd_final"] for r in rows),
                                            max(r["cd_final"] for r in rows)]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
