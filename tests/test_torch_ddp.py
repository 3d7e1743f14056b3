"""The port's data parallelism on two gloo ranks on the CPU, against one
process at the global batch.

The ranks are subprocesses that run this file as a module
(`python -m tests.test_torch_ddp RANK DIR`): they import torch and the port
only, never JAX or `tests/conftest.py`, join the process group through a
file in DIR (no port to pick), and write their results to DIR. Every join
has a time limit: a rank that hangs is killed and fails its test.

Set-up: options/synthetic/config.yaml at 32 x 32 (a ResNet18 encoder) with
uniform-noise input images (well-conditioned train-mode BatchNorm, see
tests/test_torch_train.py), R = 16 rays x S = 8 samples, K = 3 neighbour
views of which V = 1 is drawn by Gumbel top-k, a global batch of 4: rank r
holds rows r and r + 2, the loader's order. Each run takes a camera step
(iteration 0) and then a full step from the same seeded weights, in
`tpu.bn_mode` global and per_replica (`bn_replicas: 2`), with the three
`tpu.merge_*` flags false (the sequential path) and true (the merged step,
on the same draws re-sliced). The one-process per_replica run sees the rows
arranged [rank 0's; rank 1's], so that its contiguous BatchNorm blocks are
the ranks' batches.

The steps run in float64 (torch's default dtype set to it, in the ranks and
around the one-process runs): the ranks and one process differ only in the
order of sums, and in float32 a full step's gradients at this size move by
up to 4e-4 (norm-relative) when one process merely permutes its batch;
float64 shows the arrangement itself exact (measured: 1e-12 in global mode,
3e-8 in per_replica mode, whose two-sample BatchNorm blocks amplify
rounding). Tolerances: loss terms 1e-5 relative; every gradient 1e-4 in
norm relative to its own norm; post-step parameters as
tests/test_torch_train.py's full step (2 * lr max, mean below 0.02 * lr);
BatchNorm statistics 1e-5 relative to their scale. The batch-coupled losses
run in float32.
"""

import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, B = 2, 4
MODES = ("global", "per_replica")
ARRANGED = [0, 2, 1, 3]     # [rank 0's rows; rank 1's rows]
RANK_TIMEOUT_S = 240     # twice the work of the sequential runs alone


def make_opt(out, mode, merged=False):
    """The set-up's options in BatchNorm mode `mode`, with the three
    `tpu.merge_*` flags `merged` (the sequential path unless asked)."""
    from shapeclipper_torch.config import options
    opt = options.load_options(
        os.path.join(REPO, "options/synthetic/config.yaml"))
    opt.update(image_size=[32, 32], batch_size=B, seed=0, resume=False,
               load=None, tb=None, output_path=str(out), max_epoch=1)
    opt.H, opt.W = opt.image_size
    opt.data.update(num_workers=0, max_img_cat=B, preselect_NN=False)
    opt.render.update(rand_sample=16, n_samples_uniform=8)
    opt.arch.update(enc_pretrained=False, enc_network="resnet18")
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32",
                   merge_encoders=merged, merge_flip_estimator=merged,
                   merge_nn_render=merged)
    opt.tpu.update(bn_mode=mode, bn_replicas=2 if mode == "per_replica"
                   else None)
    opt.freq.update(save_vis=10 ** 6, ckpt_latest=10 ** 6)
    return opt


def rows(tree, idx):
    """The rows `idx` of every array of a (nested) batch or draws tree."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return tree[idx]
    if isinstance(tree, list):
        return [rows(t, idx) for t in tree]
    return type(tree)({k: rows(v, idx) for k, v in tree.items()})


def global_inputs(tmp):
    """The global batch and the step's draws, drawn at W = 1 from a
    generator in the order a step consumes them."""
    from shapeclipper_torch.data import synthetic
    from shapeclipper_torch.data.base import default_collate
    from shapeclipper_torch.models.graph import step_draws
    from shapeclipper_torch.train.trainer import batch_to_var
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    opt = make_opt(tmp, "global")
    ds = synthetic.Dataset(opt, split="train")
    batch = default_collate([ds[i] for i in range(B)])
    rng = np.random.RandomState(3)
    for key in ("rgb_input_map", "rgb_input_map_NN"):
        batch[key] = rng.uniform(0, 1, batch[key].shape)
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in batch.items()}
    draws = step_draws(opt, batch_to_var(batch, "cpu"), edict(),
                       torch.Generator().manual_seed(9), True)
    return batch, draws


def global_draws_merged(tmp, batch):
    """The merged step's draws for the global batch from the same
    generator (one render draw over the B query and B view rows)."""
    from shapeclipper_torch.models.graph import step_draws
    from shapeclipper_torch.train.trainer import batch_to_var
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    return step_draws(make_opt(tmp, "global"), batch_to_var(batch, "cpu"),
                      edict(), torch.Generator().manual_seed(9), True,
                      merge_nn=True)


def digest(tensors):
    return hashlib.sha1(b"".join(t.numpy().tobytes()
                                 for t in tensors.values())).hexdigest()


def run_steps(opt, batch, draws):
    """A camera step, then a full step -> per step the loss terms, the
    gradients, the parameters and BatchNorm statistics after it (rank 0's,
    as DDP's next forward and `Runner.evaluate` broadcast them), and their
    digests."""
    from shapeclipper_torch import parallel
    from shapeclipper_torch.train.trainer import Runner, batch_to_var
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    out = []
    for it in (0, 1):
        runner.it = it
        loss = runner.train_iteration(opt, batch_to_var(batch, "cpu"),
                                      draws=draws)
        g = runner.graph
        parallel.broadcast_buffers(g)
        grads = {n: p.grad.clone() for n, p in g.named_parameters()}
        params = {n: p.detach().clone() for n, p in g.named_parameters()}
        stats = {n: b.clone() for n, b in g.named_buffers()
                 if "running" in n}
        out.append(dict(
            loss={k: float(v) for k, v in loss.items() if k != "finite"},
            finite=bool(loss.finite), grads=grads, params=params,
            stats=stats, digests=[digest(t) for t in (grads, params, stats)],
            wrapper=type(runner.step_model).__name__))
    return out


# ------------------------------------------------------ batch-coupled losses
def coupled_inputs():
    """Inputs of the losses that couple the batch. Rank 0's rows (0 and 2)
    carry the larger angular errors, so that the kept 80% of the trimmed
    losses holds few of them and many of rank 1's."""
    rng = np.random.RandomState(4)
    n, R = B, 64

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    gt = unit(rng.randn(n, R, 3))
    noise = rng.randn(n, R, 3) * np.array([1.0, 0.1, 1.0, 0.1])[:, None, None]
    pred = unit(gt + noise)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return dict(
        normal_pred=f32(pred), normal_gt=f32(gt),
        mask=torch.from_numpy(rng.rand(n, R, 1) > 0.2),
        weight=f32(rng.uniform(0.5, 1.5, (n, 1, 1))),
        trig=f32(unit(rng.randn(n, 2))),
        rgb_pred=f32(rng.rand(n, R, 3)), rgb_gt=f32(rng.rand(n, R, 3)),
        mask_pred=f32(rng.rand(n, R, 1)), mask_gt=f32(rng.rand(n, R, 1)))


def coupled_losses(inp):
    """name -> (loss, the inputs it differentiates)."""
    from shapeclipper_torch import losses as L
    out = {}
    p = inp["normal_pred"].clone().requires_grad_(True)
    out["normal_tol"] = (L.normal_loss(p, inp["normal_gt"], inp["mask"],
                                       weight=inp["weight"], tolerance=0.2),
                         p)
    p = inp["normal_pred"].clone().requires_grad_(True)
    out["normal"] = (L.normal_loss(p, inp["normal_gt"], inp["mask"]), p)
    t = inp["trig"].clone().requires_grad_(True)
    out["cam_uniform"] = (L.cam_uniform_loss(t), t)
    p = inp["rgb_pred"].clone().requires_grad_(True)
    out["mse_tol"] = (L.mse_loss(p, inp["rgb_gt"], tolerance=0.2), p)
    p = inp["mask_pred"].clone().requires_grad_(True)
    out["iou_tol"] = (L.iou_loss(p, inp["mask_gt"], tolerance=0.2), p)
    return out


def coupled_values_and_grads(inp):
    res = {}
    for name, (loss, x) in coupled_losses(inp).items():
        (grad,) = torch.autograd.grad(loss, x)
        res[name] = (float(loss), grad)
    return res


# ------------------------------------------------------------------ worker
def worker(rank, tmp):
    from shapeclipper_torch import parallel
    from shapeclipper_torch.models.graph import step_draws
    from shapeclipper_torch.train.trainer import batch_to_var
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    torch.set_num_threads(2)
    torch.set_default_dtype(torch.float64)
    parallel.init(rank, W, f"file://{tmp}/pg_init", "cpu")
    batch, draws = torch.load(os.path.join(tmp, "inputs.pt"),
                              weights_only=False)
    mine = slice(rank, None, W)
    res = {}
    steps = {}
    for mode in MODES:
        for merged in (False, True):
            key = (mode, "merged") if merged else mode
            steps[key] = run_steps(
                make_opt(os.path.join(tmp, f"r{rank}_{mode}_{merged}"), mode,
                         merged), rows(batch, mine), rows(draws, mine))
            res[key] = [dict(loss=s["loss"], finite=s["finite"],
                             digests=s["digests"]) for s in steps[key]]
    opt = make_opt(os.path.join(tmp, f"r{rank}_draws"), "global")
    for merged in (False, True):
        res["draws", merged] = step_draws(
            opt, batch_to_var(rows(batch, mine), "cpu"), edict(),
            torch.Generator().manual_seed(9), True, merge_nn=merged)
    res["coupled"] = coupled_values_and_grads(rows(coupled_inputs(), mine))
    parallel.barrier()
    parallel.destroy()
    # the one-process run at the global batch of mode `rank`, held against
    # this rank's steps here (the tensors stay in this process; both ranks
    # hold the same gradients and parameters, test_ranks_stay_in_step)
    mode = MODES[rank]
    order = ARRANGED if mode == "per_replica" else list(range(B))
    for merged in (False, True):
        key = (mode, "merged") if merged else mode
        single = run_steps(make_opt(os.path.join(tmp, f"one_{mode}_{merged}"),
                                    mode, merged),
                           rows(batch, order), rows(draws, order))
        res["single", merged] = [
            dict(loss=want["loss"], finite=want["finite"],
                 errors=step_errors(got, want))
            for got, want in zip(steps[key], single)]
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def step_errors(got, want):
    """Per parameter the gradient's norm-relative error and the largest
    post-step difference; the mean difference; per BatchNorm statistic the
    largest difference relative to its scale."""
    grad, param, diffs = {}, {}, []
    for name, wg in want["grads"].items():
        grad[name] = float((got["grads"][name] - wg).norm()
                           / wg.norm().clamp(min=1e-30))
        d = (got["params"][name] - want["params"][name]).abs()
        param[name] = float(d.max())
        diffs.append(d.reshape(-1))
    stats = {name: float((got["stats"][name] - ws).abs().max()
                         / ws.abs().max().clamp(min=1e-30))
             for name, ws in want["stats"].items()}
    return dict(grad=grad, param=param,
                param_mean=float(torch.cat(diffs).mean()), stats=stats)


def run_ranks(tmp):
    """Start W ranks on `tmp`, wait at most RANK_TIMEOUT_S for all, kill
    the rest on a failure -> their results."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(W)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_ddp",
                               str(r), str(tmp)], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(W)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            pytest.fail(f"rank {r} exited with {p.returncode}:\n{tail}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(W)]


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """The two ranks' results and the one-process runs on the same
    inputs."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("ddp")
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        batch, draws = global_inputs(tmp / "inputs")
        draws_merged = global_draws_merged(tmp / "inputs", batch)
    finally:
        torch.set_default_dtype(dtype)
    torch.save((batch, draws), tmp / "inputs.pt")
    return dict(ranks=run_ranks(tmp), draws=draws, draws_merged=draws_merged)


def check_against_one_process(ddp_run, mode, step, merged):
    want = ddp_run["ranks"][MODES.index(mode)]["single", merged][step]
    lr = 1e-4
    for res in ddp_run["ranks"]:
        got = res[(mode, "merged") if merged else mode][step]
        assert got["finite"] and want["finite"]
        assert set(got["loss"]) == set(want["loss"])
        for k, v in want["loss"].items():
            np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    err = want["errors"]
    for name, e in err["grad"].items():
        assert e <= 1e-4, (name, e)
    for name, d in err["param"].items():
        assert d <= 2 * lr + 1e-6, (name, d)
    assert err["param_mean"] <= 0.02 * lr
    for name, e in err["stats"].items():
        assert e <= 1e-5, (name, e)


@pytest.mark.parametrize("step", [0, 1], ids=["camera", "full"])
@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_match_one_process(ddp_run, mode, step):
    """Both ranks' loss terms, and one rank's gradients, post-step
    parameters and BatchNorm statistics, against one process at the global
    batch."""
    check_against_one_process(ddp_run, mode, step, merged=False)


@pytest.mark.parametrize("step", [0, 1], ids=["camera", "full"])
@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_match_one_process_merged(ddp_run, mode, step):
    """The same with the three `tpu.merge_*` flags true: the grouped
    BatchNorms (each view group's moments summed over the ranks, or split
    into per-replica blocks), the merged render's rows of the sequential
    draws, DDP's unused-parameter search over the merged backward."""
    check_against_one_process(ddp_run, mode, step, merged=True)


def test_ranks_stay_in_step(ddp_run):
    """Both ranks hold the same gradients, parameters and (after the
    broadcast) running statistics after every step."""
    r0, r1 = ddp_run["ranks"]
    for mode in MODES:
        for key in (mode, (mode, "merged")):
            for s0, s1 in zip(r0[key], r1[key]):
                assert s0["digests"] == s1["digests"], key


def test_ranks_draw_their_rows_of_the_global_draws(ddp_run):
    """From the same generator, rank r draws rows r, r + W, ... of the
    draws one process takes at the global batch."""
    want = ddp_run["draws"]
    for r, res in enumerate(ddp_run["ranks"]):
        got, exp = res["draws", False], rows(want, slice(r, None, W))
        assert set(got) == set(exp)
        assert torch.equal(got.nn_uniform, exp.nn_uniform)
        for k in exp.render:
            assert torch.equal(got.render[k], exp.render[k]), k
        for g, e in zip(got.render_NN, exp.render_NN):
            assert torch.equal(g.t_rand, e.t_rand)
        # the merged render's draw over [query; NN_0]: rank r's rows of each
        # view group (the eikonal points: of the query's)
        got, exp = res["draws", True], ddp_run["draws_merged"]
        assert set(got) == {"render", "nn_uniform"}
        assert torch.equal(got.nn_uniform, exp.nn_uniform[r::W])
        for k, groups in (("t_rand", 2), ("eik_idx", 2), ("eik_uniform", 1)):
            assert torch.equal(got.render[k], torch.cat(
                [part[r::W] for part in exp.render[k].chunk(groups)])), k


def test_one_rank_under_ddp_is_no_process_group(tmp_path):
    """One gloo rank runs DDP's reducer, the global BatchNorm's all-reduce
    and the coupled losses' gathers, and takes bitwise the steps that no
    process group takes: a world of one sums one term."""
    from shapeclipper_torch import parallel
    torch.set_num_threads(2)
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        batch, draws = global_inputs(tmp_path / "inputs")
        plain = run_steps(make_opt(tmp_path / "plain", "global"), batch,
                          draws)
        parallel.init(0, 1, f"file://{tmp_path}/pg_init", "cpu")
        try:
            ddp = run_steps(make_opt(tmp_path / "ddp", "global"), batch,
                            draws)
        finally:
            parallel.destroy()
    finally:
        torch.set_default_dtype(dtype)
    for got, want in zip(ddp, plain):
        assert got["wrapper"] == "DistributedDataParallel"
        assert want["wrapper"] == "TrainStep"
        assert got["loss"] == want["loss"]
        assert got["digests"] == want["digests"]


@pytest.mark.parametrize("name", ["normal_tol", "normal", "cam_uniform",
                                  "mse_tol", "iou_tol"])
def test_coupled_losses_on_two_ranks(ddp_run, name):
    """Each rank computes the global batch's value from its own rows, and
    its gradient is W times its rows' part of the one-process gradient
    (DDP's mean over the ranks then gives the global gradient). The kept
    sets cross the ranks: a rank-local loss would differ."""
    inp = coupled_inputs()
    value, grad = coupled_values_and_grads(inp)[name]
    local = []
    for r, res in enumerate(ddp_run["ranks"]):
        v, g = res["coupled"][name]
        np.testing.assert_allclose(v, value, rtol=1e-6)
        torch.testing.assert_close(g / W, grad[r::W], rtol=1e-5,
                                   atol=1e-7)
        local.append(coupled_values_and_grads(
            rows(inp, slice(r, None, W)))[name][0])
    assert abs(np.mean(local) - value) > 1e-4 * abs(value)


def test_loader_split_is_the_global_batch():
    """Shard r of a global batch of 6 takes positions r, r + W, ...; the
    shards' batches are disjoint and together the one-process batch, every
    epoch, and a ragged tail is dropped on every shard alike."""
    from shapeclipper_torch.data.base import DataLoader

    class Items:
        def __len__(self):
            return 27

        def __getitem__(self, i):
            return {"idx": np.int64(i)}

    def epochs(loader):
        out = []
        for ep in range(3):
            loader.set_epoch(ep)
            out.append([list(b["idx"]) for b in loader])
        return out

    one = epochs(DataLoader(Items(), 6, shuffle=True, num_workers=0,
                            seed=5))
    shards = [epochs(DataLoader(Items(), 3, shuffle=True, num_workers=0,
                                seed=5, shard_id=r, num_shards=W))
              for r in range(W)]
    for ep, batches in enumerate(one):
        assert len(batches) == 4
        for k, batch in enumerate(batches):
            parts = [shards[r][ep][k] for r in range(W)]
            assert not set(parts[0]) & set(parts[1])
            assert [parts[j % W][j // W] for j in range(6)] == batch
        assert all(len(shards[r][ep]) == len(batches) for r in range(W))


def test_distributed_without_a_process_group_raises(monkeypatch):
    """`--distributed` outside torchrun, NCCL without CUDA, and a world
    size other than tpu.mesh raise; nothing falls back."""
    from shapeclipper_torch import parallel
    from shapeclipper_torch.train.__main__ import main
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    for key in parallel.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        main(["--yaml=options/synthetic/config.yaml", "--distributed",
              "--device=cpu"])
    with pytest.raises(RuntimeError, match="NCCL"):
        parallel.init(0, 1, "file:///nonexistent", "cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            parallel.init(0, 1, "file:///nonexistent", "cuda")
    assert not parallel.is_initialized()
    parallel.check_mesh(edict(tpu=edict(mesh=edict(data=1))))
    with pytest.raises(ValueError, match="world size"):
        parallel.check_mesh(edict(tpu=edict(mesh=edict(data=2))))


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2])
