"""`python -m shapeclipper_torch.evaluate --distributed` over two gloo ranks
under torchrun, against the same evaluation in one process and against the
JAX package's `Runner.evaluate` over a two-device mesh.

The set-up is `tests/test_torch_eval.py`'s slice: 5 synthetic test samples
in batches of 2 (three batches, the ragged one on rank 0), float32, the
merge flags off, host surface sampling, and the perturbed JAX weights
carried across by `bridge.py` into the `best.pt` that every process
restores. The port's ranks split the test set by whole batches (batch k on
rank k mod 2), so their reports must equal one process's byte for byte,
with dumps and without; the dumps of the two ranks together must be one
process's files. The JAX package instead splits each batch's rows over its
mesh; `eval.batch_size` 2 is a multiple of the mesh, so it rounds nothing
up, and the reports are held to JAX's with `test_evaluate_matches_jax`'s
tolerances (F-scores 1e-3 absolute, CD and chamfer.txt at TOL, cd_cat.txt
and f_score.txt to their printed digits).

Each subprocess runs in a process group of its own, with an absolute
deadline (`tests/test_torch_ddp_cli.py`'s `DEADLINE_S`, sized for a CPU
shared with five other test workers), after which it is killed with
every process below it and the test fails. The run folders are removed
once every test of the module passed (`tests/torch_tmp.py`).
"""

import os
import re
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shapeclipper_tpu import parallel as jparallel
from shapeclipper_tpu.train.trainer import Runner as JaxRunner
from shapeclipper_torch import bridge, parallel
from shapeclipper_torch.data.base import DataLoader
from shapeclipper_torch.utils import checkpoint as ckpt
from tests.test_torch_ddp_cli import finish, rank_stdout, start
from tests.test_torch_eval import (TOL, _capture_f_scores, _read,
                                   _same_printed, eval_opt, perturbed_state)
from tests.torch_native_lib import point_jax_loader_at_port_library
from tests.torch_tmp import kept_if_failed

RUN = os.path.join("synthetic_output", "run")
REPORTS = ("cd_cat.txt", "f_score.txt", "chamfer.txt")
# tests/test_torch_eval.py::eval_opt as flags of the synthetic YAML
FLAGS = ["--yaml=options/synthetic/config.yaml", "--name=run", "--seed=0",
         "--batch_size=2", "--image_size=[32,32]", "--data.num_workers=0",
         "--data.k_nearest=2", "--data.max_img_cat=5", "--eval.batch_size=2",
         "--eval.image_size=[8,8]", "--eval.vox_res=12",
         "--eval.num_points=2048", "--eval.n_vis=1", "--eval.n_vis_classes=1",
         "--render.rand_sample=16", "--render.n_samples_uniform=8",
         "--reg.n_views=1", "--arch.enc_pretrained!", "--tb!",
         "--tpu.encoder_dtype=float32", "--tpu.implicit_dtype=float32",
         "--tpu.merge_nn_render!", "--tpu.merge_flip_estimator!",
         "--tpu.merge_encoders!", "--tpu.device_isosurface!", "--device=cpu"]


def jax_opt(base_opt, out, dump):
    opt = eval_opt(base_opt, out)
    opt.eval.dump = dump
    opt.tpu.mesh = {"data": 2}
    return opt


@pytest.fixture(scope="module")
def weights(base_opt, tmp_path_factory):
    """The perturbed JAX state as a state_dict of the port's Graph."""
    opt = jax_opt(base_opt, tmp_path_factory.mktemp("init"), False)
    params, stats = perturbed_state(opt)
    return params, stats, bridge.state_dict_from_flax(params, stats)


@pytest.fixture(scope="module")
def evaluated(weights, tmp_path_factory, request):
    """-> run(dump): one process and two torchrun ranks evaluate the same
    best.pt, once for each `eval.dump` -> (the one-process run's folder,
    torchrun's, rank 0's stdout, rank 1's stdout)."""
    done = {}

    def run(dump):
        if dump not in done:
            done[dump] = evaluate_both(weights[2], dump, root)
        return done[dump]
    with kept_if_failed(request, tmp_path_factory.mktemp("ranks")) as root:
        yield run


def evaluate_both(state_dict, dump, root):
    tmp = root / ("dump" if dump else "no_dump")
    one, ddp = tmp / "one", tmp / "ddp"
    for out in (one, ddp):
        (out / RUN).mkdir(parents=True)
        ckpt.write_checkpoint(str(out / RUN / "best.pt"), state_dict)
    flags = FLAGS + ["--resume", "--eval.dump" + ("" if dump else "!")]
    logs = [tmp / "one.log", tmp / "ddp.log"]
    log_dir = str(tmp / "ranks")
    finish([start([sys.executable, "-m", "shapeclipper_torch.evaluate",
                   *flags, "--tpu.mesh={data: 1}"], one, logs[0]),
            start([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node=2",
                   f"--log-dir={log_dir}", "--redirects=3", "-m",
                   "shapeclipper_torch.evaluate", "--distributed", *flags,
                   "--tpu.mesh={data: 2}"], ddp, logs[1])], logs)
    return one / RUN, ddp / RUN, rank_stdout(log_dir, 0), rank_stdout(
        log_dir, 1)


def lines(path):
    return path.read_text().split("\n")


@pytest.mark.parametrize("dump", [False, True], ids=["no_dump", "dump"])
def test_reports_equal_one_process(evaluated, dump):
    one, ddp, _, _ = evaluated(dump)
    for name in REPORTS:
        want = (one / name).read_text()
        assert want and (ddp / name).read_text() == want, name
    rows = (one / "chamfer.txt").read_text().splitlines()
    assert [r.split()[0] for r in rows] == [str(i) for i in range(5)]


@pytest.mark.parametrize("dump", [False, True], ids=["no_dump", "dump"])
def test_rank0_alone_reports(evaluated, dump):
    """Rank 0 prints the F-score block and the `[eval]` line, rank 1
    neither."""
    _, _, rank0, rank1 = evaluated(dump)
    for pattern in (r"^F-score @ ", r"^#{30}$", r"^\[eval\]"):
        assert re.search(pattern, rank0, re.M), pattern
        assert not re.search(pattern, rank1, re.M), pattern


def test_dumps_split_over_ranks(evaluated):
    """The two ranks' dump/ files together are one process's, byte for
    byte."""
    one, ddp, _, _ = evaluated(True)
    want = sorted(os.listdir(one / "dump"))
    assert "4_mesh.ply" in want and "4_pointclouds_comp.ply" in want
    assert sorted(os.listdir(ddp / "dump")) == want
    for name in want:
        assert ((ddp / "dump" / name).read_bytes()
                == (one / "dump" / name).read_bytes()), name


def test_ranks_match_jax_mesh(evaluated, weights, base_opt,
                              tmp_path_factory):
    """JAX's Runner.evaluate over a two-device mesh (eval.dump false, as
    the ranks' run) on the same weights."""
    _, ddp, _, _ = evaluated(False)
    params, stats, _ = weights
    opt = jax_opt(base_opt, tmp_path_factory.mktemp("jax_mesh"), False)
    with pytest.MonkeyPatch.context() as mp:
        point_jax_loader_at_port_library(mp)
        jr = JaxRunner(opt)
        assert jr.mesh.size == 2 and opt.eval.batch_size == 2
        jr.load_dataset(opt, eval_split="test")
        jr.build_networks(opt)
        jr.setup_optimizer(opt)
        jr.restore_checkpoint(opt)
        jr.params = jparallel.replicate(
            jr.mesh, jax.tree_util.tree_map(jnp.asarray, params))
        jr.batch_stats = jparallel.replicate(
            jr.mesh, jax.tree_util.tree_map(jnp.asarray, stats))
        jf = _capture_f_scores(jr)
        jcd = jr.evaluate(opt, ep=0)
    jf = np.concatenate(jf)
    assert jf.shape == (5, len(opt.eval.f_thresholds))

    tc = [r.split() for r in lines(ddp / "chamfer.txt") if r]
    jc = [r.split() for r in _read(opt, "chamfer.txt") if r]
    assert [r[0] for r in tc] == [r[0] for r in jc] == [str(i)
                                                        for i in range(5)]
    tvals = np.array([r[1:] for r in tc], float)
    np.testing.assert_allclose(tvals, np.array([r[1:] for r in jc], float),
                               **TOL)
    np.testing.assert_allclose(tvals.mean(), jcd, **TOL)
    tfs = [float(r.split(": ")[1]) for r in lines(ddp / "f_score.txt") if r]
    np.testing.assert_allclose(tfs, jf.mean(axis=0), rtol=0, atol=1e-3)
    for name in ("cd_cat.txt", "f_score.txt"):
        got, want = lines(ddp / name), _read(opt, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _same_printed(g, w)


# ------------------------------------------------------- the loader shard
class Counted:
    """11 samples (batches of 3: the last one ragged) that record which
    indices were built."""

    def __init__(self):
        self.built = []

    def __len__(self):
        return 11

    def __getitem__(self, i):
        self.built.append(int(i))
        return {"idx": np.int64(i), "x": np.full(4, i * 0.5, np.float32)}


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("W", [2, 3])
def test_loader_batch_shard(W, num_workers):
    """Rank r builds exactly batches r, r + W, ... and hands out their
    indices in the unsharded sequence; the ranks' batches together are one
    loader's, byte for byte."""
    whole = Counted()
    want = list(enumerate(DataLoader(whole, 3, drop_last=False,
                                     num_workers=num_workers)))
    assert len(want) == 4 and len(want[-1][1]["idx"]) == 2
    got = {}
    for r in range(W):
        ds = Counted()
        loader = DataLoader(ds, 3, drop_last=False, num_workers=num_workers,
                            batch_shard_id=r, num_batch_shards=W)
        pairs = list(loader.indexed())
        ks = list(range(r, 4, W))
        assert [k for k, _ in pairs] == ks and len(loader) == len(ks)
        assert sorted(ds.built) == [i for k in ks
                                    for i in range(3 * k, min(3 * k + 3, 11))]
        got.update(pairs)
    assert sorted(got) == [k for k, _ in want]
    for k, batch in want:
        assert got[k].keys() == batch.keys()
        for key in batch:
            assert got[k][key].dtype == batch[key].dtype
            np.testing.assert_array_equal(got[k][key], batch[key])


# ----------------------------------------------------------------- errors
def test_distributed_outside_torchrun_raises(monkeypatch):
    from shapeclipper_torch.evaluate import main
    for key in parallel.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        main(["--yaml=options/synthetic/config.yaml", "--distributed",
              "--device=cpu"])
    assert not parallel.is_initialized()


def test_mesh_other_than_world_size_raises(monkeypatch, tmp_path):
    """One gloo rank in this process with tpu.mesh.data 2: the mesh check
    raises, and the process group is gone after it."""
    from shapeclipper_torch.evaluate import main
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="world size"):
        main(FLAGS + ["--distributed", "--tpu.mesh={data: 2}",
                      f"--output_root={tmp_path}"])
    assert not parallel.is_initialized()
