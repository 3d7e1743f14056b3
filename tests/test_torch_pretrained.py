"""ImageNet-pretrained initialisation: the same converted .npz files
(torchvision names, as `scripts/convert_weights.py` writes them) loaded
through the JAX package's `Graph.init` and the port's
`Runner.build_networks`. The loaded state_dicts must agree (through
`bridge`), and so must the encoder's and the estimator backbone's outputs
on one seeded image, at rtol/atol 1e-5 (relative to the output scale for
the outputs). The npz files are made from a seed; no real weights are
needed."""

import jax
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.models.resnet import resnet18 as jax_resnet18
from shapeclipper_tpu.models.resnet import resnet34 as jax_resnet34
from shapeclipper_torch import bridge
from shapeclipper_torch.models.resnet import resnet18, resnet34
from shapeclipper_torch.train.trainer import Runner
from tests.torch_tmp import kept_if_failed, tmp_path  # noqa: F401

torch.set_num_threads(2)
TOL = 1e-5
SIZE = 32
MISSING = ("pretrained weights {path} missing — {top} trains from scratch "
           "(convert weights with scripts/convert_weights.py; see "
           "RUNBOOK.md)")


def _write_npz(path, net, seed):
    """A torchvision-named state_dict with seeded values (BN statistics
    away from their defaults), `num_batches_tracked` and a 1000-way fc."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = np.array(7, np.int64)
        elif name.endswith("running_var"):
            out[name] = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
        else:
            out[name] = (rng.randn(*t.shape) * 0.1).astype(np.float32)
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory, request):
    with kept_if_failed(request, tmp_path_factory.mktemp("weights")) as root:
        enc = _write_npz(root / "resnet34.npz", resnet34(num_classes=1000), 1)
        est = _write_npz(root / "resnet18.npz", resnet18(num_classes=1000), 2)
        yield str(root / "resnet34.npz"), str(root / "resnet18.npz"), enc, est


def _opt(base_opt, tmp_path, enc_path, est_path, enc_pretrained):
    opt = base_opt.deepcopy()
    opt.image_size = [SIZE, SIZE]
    opt.H, opt.W = SIZE, SIZE
    opt.arch.enc_pretrained = enc_pretrained
    opt.arch.enc_weights = enc_path
    opt.arch.est_weights = est_path
    opt.tpu.encoder_dtype = "float32"
    opt.tpu.implicit_dtype = "float32"
    opt.output_path = str(tmp_path)
    opt.resume = False
    opt.load = None
    return opt


def _port_graph(opt):
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    return runner.graph


def _loaded(state, prefix, want):
    """The entries of `state` under `prefix` that the npz `want` sets."""
    return {k: state[prefix + k] for k in want
            if not k.startswith("fc.") and "num_batches" not in k}


@pytest.mark.parametrize("enc_pretrained", [True, False])
def test_pretrained_npz_loads_as_in_jax(base_opt, npz_files, tmp_path,
                                        enc_pretrained, capsys):
    enc_path, est_path, enc_npz, est_npz = npz_files
    opt = _opt(base_opt, tmp_path, enc_path, est_path, enc_pretrained)
    state = jax.jit(JaxGraph(opt).init)(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    stats = jax.tree_util.tree_map(np.asarray, state["batch_stats"])
    graph = _port_graph(opt)
    out = capsys.readouterr().out
    assert "missing" not in out
    assert (f"loaded pretrained encoder weights from {enc_path}" in out) \
        == enc_pretrained
    assert f"loaded pretrained estimator weights from {est_path}" in out

    got, want = graph.state_dict(), bridge.state_dict_from_flax(params,
                                                                stats)
    for prefix, npz, loaded in (("encoder.", enc_npz, enc_pretrained),
                                ("estimator.feature_extractor.", est_npz,
                                 True)):
        port, jax_side = _loaded(got, prefix, npz), _loaded(want, prefix, npz)
        for k, v in port.items():
            ref = torch.from_numpy(npz[k])
            if loaded:      # both packages hold the npz's values
                torch.testing.assert_close(v, jax_side[k], rtol=TOL,
                                           atol=TOL, msg=prefix + k)
                assert torch.equal(v, ref), prefix + k
            else:           # seeded (and different) initialisations
                assert not torch.equal(v, ref), prefix + k
                assert not torch.equal(jax_side[k], ref), prefix + k

    # outputs on one seeded image: the port's modules as loaded (the
    # encoder's fc, which no npz sets, taken from the JAX side) against the
    # JAX modules with the JAX package's loaded variables
    x = np.random.RandomState(3).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    with torch.no_grad():
        graph.encoder.fc.weight.copy_(want["encoder.fc.weight"])
        graph.encoder.fc.bias.copy_(want["encoder.fc.bias"])
    cases = (
        (graph.encoder, jax_resnet34(num_classes=graph.encoder.fc.
                                     out_features),
         params["encoder"], stats["encoder"]),
        (graph.estimator.feature_extractor, jax_resnet18(num_classes=None),
         params["estimator"]["ResNet_0"], stats["estimator"]["ResNet_0"]))
    for module, jnet, p, s in cases[0 if enc_pretrained else 1:]:
        with torch.inference_mode():
            y = module.eval()(torch.from_numpy(x)).numpy()
        ref = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
            {"params": p, "batch_stats": s}, x))
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(y, ref, atol=TOL * scale, rtol=TOL)


def test_missing_npz_warns_and_keeps_the_seeded_init(base_opt, tmp_path,
                                                     capsys):
    enc_path = str(tmp_path / "none34.npz")
    est_path = str(tmp_path / "none18.npz")
    opt = _opt(base_opt, tmp_path, enc_path, est_path, True)
    graph = _port_graph(opt)
    out = capsys.readouterr().out
    assert MISSING.format(path=enc_path, top="encoder") in out
    assert MISSING.format(path=est_path, top="estimator") in out
    # the same seed with no pretrained job at all: the same weights
    seeded = _port_graph(_opt(base_opt, tmp_path, None, est_path, False))
    for k, v in seeded.state_dict().items():
        assert torch.equal(graph.state_dict()[k], v), k


def test_npz_entry_without_counterpart_raises(base_opt, npz_files, tmp_path):
    _, est_path, _, est_npz = npz_files
    bad = dict(est_npz, **{"layer5.0.conv1.weight": np.zeros(3, np.float32)})
    path = str(tmp_path / "bad.npz")
    np.savez(path, **bad)
    opt = _opt(base_opt, tmp_path, None, path, False)
    with pytest.raises(KeyError, match="layer5.0.conv1.weight"):
        _port_graph(opt)
