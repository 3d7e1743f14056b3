"""`torchrun --nproc_per_node=2 -m shapeclipper_torch.train --distributed
--device=cpu` at the tiny size of the verify notes, against the same run in
one process.

Both runs start from the same seeded weights with `optim.lr=0` and every
step a camera step (`optim.iter_camera` past the run), so that the weights
and BatchNorm statistics stay the seeded ones: in float32 the first Adam
steps move a parameter whose gradient is near zero by about +-lr depending
on the rounding of its gradient, so any two orders of summation train
weights that differ at lr level (tests/test_torch_ddp.py holds the
distributed steps against one process in float64). What the reports then
compare is the distributed loop itself: the loader's split, the two ranks'
steps in lock step, the training evaluations split over the ranks and
gathered, the best-epoch choice, and rank 0's writes. The full evaluation
of each run's best.pt must give byte-equal cd_cat.txt, f_score.txt and
chamfer.txt, and the logs the same `Best CD` and checkpoint lines (rank 1
writes none).
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
TINY = ["--yaml=options/synthetic/config.yaml", "--name=run",
        "--max_epoch=1", "--batch_size=2", "--image_size=[32,32]",
        "--render.rand_sample=32", "--render.n_samples_uniform=8",
        "--eval.vox_res=12", "--eval.num_points=512",
        "--eval.image_size=[16,16]", "--data.max_img_cat=4", "--tb!",
        "--device=cpu", "--eval.dump!", "--tpu.encoder_dtype=float32",
        "--tpu.implicit_dtype=float32"]
TRAIN = ["--freq.eval=1", "--optim.lr=0", "--optim.iter_camera=1000"]
REPORTS = ("cd_cat.txt", "f_score.txt", "chamfer.txt")


def start(cmd, out, log):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(cmd + [f"--output_root={out}"], cwd=REPO,
                            env=env, stdout=open(log, "w"),
                            stderr=subprocess.STDOUT)


def finish(procs, logs):
    """Wait for every process (TIMEOUT_S in all), kill the rest on a
    failure, fail with the log of the first that did not exit 0."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            with open(log) as f:
                pytest.fail(f"{p.args[:4]} exited with {p.returncode}:\n"
                            f"{f.read()[-3000:]}")
    out = []
    for log in logs:
        with open(log) as f:
            out.append(f.read())
    return out


def test_torchrun_train_matches_one_process(tmp_path):
    one, ddp = tmp_path / "one", tmp_path / "ddp"
    logs = [tmp_path / "one.log", tmp_path / "ddp.log"]
    procs = [
        start([sys.executable, "-m", "shapeclipper_torch.train",
               *TINY, *TRAIN], one, logs[0]),
        start([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=2", "-m", "shapeclipper_torch.train",
               "--distributed", *TINY, *TRAIN], ddp, logs[1])]
    text = finish(procs, logs)

    def lines(log, pattern):
        return [ln for ln in log.splitlines() if re.search(pattern, ln)]

    best = [lines(t, r"^Best CD: ") for t in text]
    assert len(best[0]) == 1 and best[0] == best[1]
    for pattern in (r"^checkpoint saved: ", r"^Saving the current model",
                    r"^\[eval\]"):
        assert lines(text[0], pattern), pattern
        assert lines(text[1], pattern) == lines(text[0], pattern), pattern
    run = "synthetic_output/run"
    for out in (one, ddp):
        assert (out / run / "best.pt").is_file()
        assert (out / run / "checkpoint" / "ep1.pt").is_file()

    evals = [tmp_path / "eval_one.log", tmp_path / "eval_ddp.log"]
    finish([start([sys.executable, "-m", "shapeclipper_torch.evaluate",
                   *TINY, "--resume"], out, log)
            for out, log in zip((one, ddp), evals)], evals)
    for name in REPORTS:
        a = (one / run / name).read_text()
        assert a and a == (ddp / run / name).read_text(), name
