"""The port's epoch loop (`Runner.train`, `train_epoch`, the resume
fast-forward, the iteration hooks), its two checkpoint restores (evaluate
mode, per-child `--load`) and the train / evaluate CLIs, on the CPU at a
tiny size (synthetic data, 32x32 images, 16 rays x 8 samples, vox 8).

`reset_scale_params` is held against the JAX package's on the same
weights through `bridge.py`; the rest is control flow the JAX package
defines (`shapeclipper_tpu/train/trainer.py:272-328`,
`shapeclipper_tpu/utils/checkpoint.py:67-125`), checked on the port's
files and counters.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.estimator import reset_scale_params as jreset
from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.utils.easydict import EasyDict as jedict
from shapeclipper_torch import bridge
from shapeclipper_torch.models.estimator import reset_scale_params
from shapeclipper_torch.models.graph import Graph
from shapeclipper_torch.train.trainer import Runner, batch_to_var
from shapeclipper_torch.utils import checkpoint as ckpt
from shapeclipper_torch.utils.log import log
from tests.torch_tmp import tmp_path  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY = ["--yaml=options/synthetic/config.yaml", "--batch_size=2",
        "--image_size=[32,32]", "--render.rand_sample=16",
        "--render.n_samples_uniform=8", "--eval.vox_res=8",
        "--eval.num_points=256", "--eval.image_size=[8,8]",
        "--data.max_img_cat=4", "--data.num_workers=0", "--tb!"]


def loop_opt(base_opt, out, max_img_cat=4):
    opt = base_opt.deepcopy()
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    opt.update(image_size=[32, 32], batch_size=2, seed=0, resume=False,
               load=None, tb=False, output_path=str(out), max_epoch=2)
    opt.H, opt.W = opt.image_size
    opt.data.update(dataset="synthetic", num_workers=0, k_nearest=2,
                    max_img_cat=max_img_cat)
    opt.data.synthetic = jedict(cat="synthetic", azim_range=[-180, 180],
                                elev_range=[-90, 90], theta_range=[-90, 90])
    opt.eval.update(batch_size=2, image_size=[8, 8], vox_res=8,
                    num_points=256, n_vis=1, n_vis_classes=1)
    opt.render.update(rand_sample=16, n_samples_uniform=8)
    opt.reg.n_views = 1
    opt.freq.update(eval=1, ckpt_latest=10 ** 6, save_vis=10 ** 6,
                    scalar=10 ** 6, vis=10 ** 6)
    return opt


def make_runner(opt, load_data=True):
    runner = Runner(opt, "cpu")
    if load_data:
        runner.load_dataset(opt)
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    return runner


def test_reset_scale_params_matches_jax(base_opt):
    opt = base_opt.deepcopy()
    opt.arch.enc_pretrained = False
    opt.H, opt.W = 32, 32
    state = jax.jit(JaxGraph(opt).init)(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    stats = jax.tree_util.tree_map(np.asarray, state["batch_stats"])
    rng = np.random.RandomState(0)
    for head in ("size_fc", "perspect_fc"):
        for k, v in params["estimator"][head].items():
            params["estimator"][head][k] = rng.randn(*v.shape).astype(
                np.float32)
    graph = Graph(opt)
    graph.load_state_dict(bridge.state_dict_from_flax(params, stats))
    assert float(graph.estimator.size_fc.weight.detach().abs().max()) > 0
    reset_scale_params(graph.estimator)
    params["estimator"] = jax.tree_util.tree_map(
        np.asarray, jreset(params["estimator"]))
    want = bridge.state_dict_from_flax(params, stats)
    for k, v in graph.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    assert float(graph.estimator.size_fc.weight.detach().abs().max()) == 0.0


def test_train_evaluates_and_keeps_checkpoints(base_opt, tmp_path):
    """Evaluation at epoch 0 and after every epoch (freq.eval = 1), before
    any step at epoch 0 and right after reset_scale_params; best.pt follows
    the smallest CD; latest.pt and checkpoint/ep2.pt at the end."""
    opt = loop_opt(base_opt, tmp_path)
    runner = make_runner(opt)
    with torch.no_grad():
        runner.graph.estimator.size_fc.weight.fill_(0.5)
    evaluate = runner.evaluate
    cds = iter([0.5, 0.3, 0.4])
    seen = []

    def spy(o, ep, training=False):
        real = evaluate(o, ep, training=training)
        seen.append((ep, training, runner.it,
                     float(runner.graph.estimator.size_fc.weight.abs().max()),
                     real))
        return next(cds)

    runner.evaluate = spy
    runner.train(opt)
    assert [s[:3] for s in seen] == [(0, True, 0), (1, True, 2),
                                     (2, True, 4)]
    assert seen[0][3] == 0.0                # reset before the first eval
    assert all(np.isfinite(s[4]) and s[4] > 0 for s in seen)
    assert (runner.best_val, runner.best_ep) == (0.3, 1)
    best = torch.load(tmp_path / "best.pt", weights_only=True)
    assert (best["epoch"], best["iter"], best["best_val"]) == (1, 2, 0.3)
    latest = torch.load(tmp_path / "latest.pt", weights_only=True)
    assert (latest["epoch"], latest["iter"]) == (2, 4)
    assert sorted(os.listdir(tmp_path / "checkpoint")) == ["ep2.pt"]
    # the training evaluations dump the visualization sample's rotations
    for ep in (0, 1, 2):
        files = os.listdir(tmp_path / f"vis_{ep}")
        assert {"0_image_rotate.gif", "0_mesh.ply",
                "0_pointclouds_comp.ply"} <= set(files)


def test_resume_fast_forwards_within_the_epoch(base_opt, tmp_path):
    """latest.pt at (epoch 0, iteration 3) of a 4-batch epoch: a resumed
    run skips the epoch's first three batches on the host, runs the fourth,
    does not evaluate at epoch 0, and goes on at iteration 4."""
    opt = loop_opt(base_opt, tmp_path, max_img_cat=8)
    opt.max_epoch = 1
    src = make_runner(opt, load_data=False)
    src.save_checkpoint(opt, ep=0, it=3, best_val=0.7, latest=True)
    opt.resume = True
    runner = make_runner(opt)
    assert (runner.epoch_start, runner.iter_start, runner.best_val) == (0, 3,
                                                                        0.7)
    runner.train_loader.set_epoch(0)
    order = [np.asarray(b["idx"]).tolist() for b in runner.train_loader]
    assert len(order) == 4
    steps, evals = [], []

    def step(o, var, draws=None):
        steps.append((runner.it, var.idx.tolist()))
        runner.it += 1
        return {"all": torch.tensor(1.0)}

    runner.train_iteration = step
    runner.evaluate = lambda o, ep, training=False: evals.append(ep) or 0.2
    runner.train(opt)
    assert steps == [(3, order[3])]
    assert evals == [1]
    assert (runner.best_val, runner.best_ep) == (0.2, 1)


def test_evaluate_mode_restore_is_not_strict(base_opt, tmp_path, capsys):
    opt = loop_opt(base_opt, tmp_path)
    src = make_runner(opt, load_data=False)
    with torch.no_grad():
        src.graph.sdf_network.lin0.bias.add_(1.0)
    src.save_checkpoint(opt, ep=1, it=2, best_val=0.3, best=True)
    payload = torch.load(tmp_path / "best.pt", weights_only=True)
    beta = payload["graph"].pop("density.beta")
    payload["graph"]["extra.weight"] = beta
    torch.save(payload, tmp_path / "best.pt")
    opt.resume = True
    dst = Runner(opt, "cpu")
    dst.build_networks(opt)
    dst.setup_optimizer(opt)
    with pytest.raises(RuntimeError, match="density.beta"):
        dst.restore_checkpoint(opt, best=True)
    capsys.readouterr()
    dst.restore_checkpoint(opt, best=True, evaluate=True)
    out = capsys.readouterr().out
    assert "missing keys: ['density.beta']" in out
    assert "unexpected keys: ['extra.weight']" in out
    torch.testing.assert_close(dst.graph.sdf_network.lin0.bias,
                               src.graph.sdf_network.lin0.bias)
    assert (dst.epoch_start, dst.iter_start, dst.best_val) == (1, 2, 0.3)


def test_load_restores_per_child(base_opt, tmp_path, capsys):
    """--load of a file that holds some top-level children (a pretraining
    checkpoint's shape): those are restored, the others keep the seeded
    initialisation; epoch and iteration start at 0."""
    opt = loop_opt(base_opt, tmp_path)
    src = make_runner(opt, load_data=False)
    state = {k: v + 1.0 if v.is_floating_point() else v
             for k, v in src.graph.state_dict().items()
             if k.split(".")[0] in ("sdf_network", "latent_proj_shape")}
    ckpt.write_checkpoint(str(tmp_path / "pre.pt"), state, ep=5, it=50)
    opt.load = str(tmp_path / "pre.pt")
    capsys.readouterr()
    dst = make_runner(opt, load_data=False)
    out = capsys.readouterr().out
    assert "restoring sdf_network..." in out
    assert "restoring latent_proj_shape..." in out
    assert "skipping encoder..." in out and "skipping density..." in out
    got = dst.graph.state_dict()
    for k, v in src.graph.state_dict().items():
        want = state.get(k, v)
        torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=k)
    assert (dst.epoch_start, dst.iter_start) == (0, 0)


def test_tensorboard_hooks(base_opt, tmp_path):
    """With `tb` on, iteration 0 writes the image panels and the scalars,
    the train-split Chamfer included, and logs no warning; a fresh Runner
    clears the event files and vis folders of the run."""
    pytest.importorskip("tensorboard")
    opt = loop_opt(base_opt, tmp_path)
    opt.tb = jedict(num_images=[4, 8])
    opt.freq.update(vis=1, scalar=1)
    runner = make_runner(opt)
    runner.setup_visualizer(opt)
    added, warned = [], []
    for name in ("add_scalar", "add_image"):
        real = getattr(runner.tb, name)
        setattr(runner.tb, name, lambda tag, *a, real=real, **k:
                (added.append(tag), real(tag, *a, **k)))
    warn = log.warn
    log.warn = warned.append
    try:
        batch = next(iter(runner.train_loader))
        runner.train_iteration(opt, batch_to_var(batch, "cpu"))
    finally:
        log.warn = warn
    runner.tb.close()
    assert not warned
    for tag in ("train/loss_render", "train/loss_all", "train/beta",
                "train/dist_acc", "train/dist_cov",
                "train/image_input_map", "train/image_input_map_NN_0"):
        assert tag in added, tag
    assert any("tfevents" in f for f in os.listdir(tmp_path))
    os.makedirs(tmp_path / "vis_3")
    Runner(opt, "cpu")
    assert not any("tfevents" in f or "vis" in f
                   for f in os.listdir(tmp_path))


def _cli(module, args, tmp_path, tiny=TINY):
    r = subprocess.run([sys.executable, "-m", module, *tiny,
                        f"--output_root={tmp_path}", "--name=run",
                        "--device=cpu", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_train_and_evaluate_clis_on_cpu(tmp_path):
    """`python -m shapeclipper_torch.train --device=cpu` for one epoch, then
    `python -m shapeclipper_torch.evaluate --resume --device=cpu`."""
    out = _cli("shapeclipper_torch.train", ["--max_epoch=1", "--freq.eval=1"],
               tmp_path)
    assert "Best CD:" in out
    run = tmp_path / "synthetic_output" / "run"
    for f in ("best.pt", "latest.pt", "checkpoint/ep1.pt", "options.yaml"):
        assert (run / f).is_file(), f
    assert not (run / "profile").exists()   # no tpu.profile_iters
    out = _cli("shapeclipper_torch.evaluate", ["--resume"], tmp_path)
    for f in ("cd_cat.txt", "f_score.txt", "chamfer.txt"):
        assert (run / f).is_file(), f
    rows = [l.split() for l in (run / "chamfer.txt").read_text().splitlines()]
    assert len(rows) == 4
    assert all(np.isfinite(float(x)) for r in rows for x in r[1:])
    assert "F-score @ 1.00" in (run / "f_score.txt").read_text()
    assert (run / "dump" / "3_mesh.ply").is_file()


def test_profile_window_writes_one_trace(tmp_path):
    """`--tpu.profile_iters=[1,3]` through the train CLI over one epoch of
    four iterations: torch.profiler opens before iteration 1 and closes
    before iteration 3, and one Chrome trace of iterations 1-2 lands in
    `output_path/profile/`, holding the steps' operators and the port's
    ranges of a step (`utils/trace.py`)."""
    import json
    tiny = [a for a in TINY if not a.startswith("--data.max_img_cat")]
    out = _cli("shapeclipper_torch.train",
               ["--max_epoch=1", "--freq.eval=1", "--data.max_img_cat=8",
                "--tpu.profile_iters=[1,3]", "--force_add"], tmp_path, tiny)
    run = tmp_path / "synthetic_output" / "run"
    traces = os.listdir(run / "profile")
    assert traces == ["trace_iters_1-2.json"], traces
    assert f"profiler trace written to {run / 'profile' / traces[0]}" in out
    assert "profiler window iterations 1-2" in out
    with open(run / "profile" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::convolution", "aten::lerp_"} <= names
    assert {"sc.step.batch", "sc.step.forward", "sc.step.backward",
            "sc.step.optimizer", "sc.sync.finite", "sc.graph.encode",
            "sc.render", "sc.render.eikonal", "sc.sync.batch",
            "sc.sync.inv", "sc.sync.const"} <= names
