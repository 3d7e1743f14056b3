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

Each rank's output is its own file (torchrun's `--log-dir` with
`--redirects 3`), so the lines compared are rank 0's, never two ranks'
output merged into one stream. Every process starts in a process group of
its own and is killed with the whole group and every process below it
(torchrun's ranks run in sessions of their own) when it passes its
deadline, so no rank outlives the test.
The limit: each process, torchrun included, DEADLINE_S from its own start,
not a multiple of another run's time: the one-process run and torchrun
start together on a CPU that the other test workers share, and their
times vary with that load independently (on 8 cores beside five busy
workers the one-process run took 45.9 s, torchrun up to 125 s). Measured
alone on 8 CPU cores: the one-process run 11.6 s, the whole test 22 s.
"""

import glob
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from tests.torch_tmp import tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 300
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
    """A process in a process group of its own, its output into `log`,
    with its deadline (`.deadline`, monotonic)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    with open(log, "w") as f:
        p = subprocess.Popen(cmd + [f"--output_root={out}"], cwd=REPO,
                             env=env, stdout=f, stderr=subprocess.STDOUT,
                             process_group=0)
    p.deadline = time.monotonic() + DEADLINE_S
    return p


def descendants(pid):
    """Every live process below `pid`, from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def kill_group(p):
    """The process, its group and everything it started: torchrun starts
    each rank in a session of its own, out of reach of the group kill."""
    if p.poll() is None:
        for pid in descendants(p.pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    p.wait()


def finish(procs, logs):
    """Wait for every process until its deadline, kill every group, fail
    with the log of the first that passed its deadline or did not exit 0
    -> their logs."""
    late = []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(p.deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                late.append(p)
    finally:
        for p in procs:
            kill_group(p)
    out = []
    for p, log in zip(procs, logs):
        with open(log) as f:
            text = f.read()
        if p in late:
            pytest.fail(f"{p.args[:4]} passed its deadline of {DEADLINE_S} "
                        f"s:\n{text[-3000:]}")
        if p.returncode != 0:
            pytest.fail(f"{p.args[:4]} exited with {p.returncode}:\n"
                        f"{text[-3000:]}")
        out.append(text)
    return out


def rank_stdout(log_dir, rank):
    """torchrun's `<log_dir>/<run id>/attempt_<n>/<rank>/stdout.log`."""
    paths = glob.glob(os.path.join(log_dir, "*", "attempt_*", str(rank),
                                   "stdout.log"))
    assert len(paths) == 1, (rank, paths)
    with open(paths[0]) as f:
        return f.read()


def test_torchrun_train_matches_one_process(tmp_path):
    one, ddp = tmp_path / "one", tmp_path / "ddp"
    logs = [tmp_path / "one.log", tmp_path / "ddp.log"]
    log_dir = str(tmp_path / "ranks")
    one_log, _ = finish([
        start([sys.executable, "-m", "shapeclipper_torch.train",
               *TINY, *TRAIN], one, logs[0]),
        start([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=2", f"--log-dir={log_dir}", "--redirects=3",
               "-m", "shapeclipper_torch.train", "--distributed", *TINY,
               *TRAIN], ddp, logs[1])], logs)
    text = [one_log, rank_stdout(log_dir, 0)]
    rank1 = rank_stdout(log_dir, 1)

    def lines(log, pattern):
        return [ln for ln in log.splitlines() if re.search(pattern, ln)]

    best = [lines(t, r"^Best CD: ") for t in text]
    assert len(best[0]) == 1 and best[0] == best[1]
    for pattern in (r"^checkpoint saved: ", r"^Saving the current model",
                    r"^\[eval\]"):
        assert lines(text[0], pattern), pattern
        assert lines(text[1], pattern) == lines(text[0], pattern), pattern
    for pattern in (r"^Best CD: ", r"^checkpoint saved: ",
                    r"^Saving the current model"):
        assert not lines(rank1, pattern), pattern
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
