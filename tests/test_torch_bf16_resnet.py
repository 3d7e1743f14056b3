"""The port's bfloat16 ResNets and BatchNorm against the JAX package's.

JAX side: `GroupBatchNorm(dtype=bfloat16)` (tests/test_group_bn.py's bf16
case) and `resnet18` / `resnet34(dtype=bfloat16)`, the flagship's
`tpu.encoder_dtype`: bf16 convolutions, BatchNorm moments and normalisation
in float32 with a bf16 result, float32 parameters, the pooled features cast
to float32 before `fc`. Port side: `models/layers.py::BatchNorm` on a bf16
input and `models/resnet.py::ResNet(dtype=torch.bfloat16)`. Same weights
(through `shapeclipper_torch.bridge`), same seeded numpy inputs, on the CPU.

Tolerances, and why. Both sides normalise in float32 and round the result
to bfloat16, and both round a convolution's float32 sums to bf16 (torch's
CPU kernel differs from that rounding in about 1 of 13,000 outputs, by one
bf16 ulp). So BatchNorm and a BasicBlock agree but for such flips. Through
a whole ResNet the flips spread: a flipped value feeds every later layer.
Each check holds the mean absolute difference from JAX, relative to the
output scale, under a bound, and asserts that the bound lies under half of
the port's own float32-to-bf16 gap on the same inputs (the same measure),
so that a port that quietly ran in float32 would fail. Measured here: the
block 1e-8 against a gap of 3e-4; ResNet18 / ResNet34 in eval mode
4.4e-4 / 1.5e-3 against 4.3e-3 / 5.4e-3.

Two settings are no parity settings for bf16, and are left out: JAX under
`jax.jit`, whose CPU fusion keeps some bf16 intermediates in float32 (that
moves ResNet18's output by 4.3e-3 of its scale, as far as the whole bf16
effect), so the JAX side runs op by op as the modules declare; and a whole
ResNet in train mode at batch 4, where BatchNorm over four samples turns
the flips into differences (2.7e-2) of the size of the bf16 effect itself
(4.6e-2). Train mode is checked on BatchNorm and on the block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.layers import GroupBatchNorm
from shapeclipper_tpu.models.resnet import BasicBlock as JaxBasicBlock
from shapeclipper_tpu.models.resnet import resnet18 as jax_resnet18
from shapeclipper_tpu.models.resnet import resnet34 as jax_resnet34
from shapeclipper_torch import bridge
from shapeclipper_torch.models.layers import BatchNorm
from shapeclipper_torch.models.resnet import BasicBlock, resnet18, resnet34
from tests.test_torch_modules import (_load, _np, _randomize_bn_scales,
                                      _randomize_stats)

torch.set_num_threads(2)
# bounds on mean |port - JAX| / max|JAX|
BN_TOL = 1e-4
BLOCK_TOL = 1e-5
RESNET_TOL = {18: 1.5e-3, 34: 2.5e-3}


def _mean_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).max())


@pytest.mark.parametrize("train", [True, False])
def test_bf16_batchnorm_matches_group_batchnorm(train):
    """tests/test_group_bn.py's bf16 case on the port: a bf16 input
    [6, 5, 5, 8] (NHWC; [6, 8, 5, 5] for the port), perturbed scale, bias
    and statistics; the output is bf16, the running statistics float32."""
    x = jax.random.normal(jax.random.PRNGKey(0), (6, 5, 5, 8))
    x = np.array(x.astype(jnp.bfloat16).astype(jnp.float32))
    gbn = GroupBatchNorm(use_running_average=not train, momentum=0.9,
                         epsilon=1e-5, dtype=jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    v = _np(gbn.init(jax.random.PRNGKey(1), xj))
    v["params"]["scale"] = v["params"]["scale"] * 1.3 + 0.1
    v["params"]["bias"] = v["params"]["bias"] + 0.05
    v["batch_stats"]["mean"] = v["batch_stats"]["mean"] + 0.2
    v["batch_stats"]["var"] = v["batch_stats"]["var"] * 1.7
    if train:
        y_ref, m_ref = gbn.apply(v, xj, mutable=["batch_stats"])
    else:
        y_ref = gbn.apply(v, xj)
    assert y_ref.dtype == jnp.bfloat16

    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    bn.train(train)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        y = bn(xt.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    want = np.asarray(y_ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = y.float().numpy()
    err = _mean_rel(got, want)
    assert err <= BN_TOL, err
    # the port's float32 normalisation of the same input and state
    f32 = BatchNorm(8)
    f32.load_state_dict(_state_before(v))
    f32.train(train)
    with torch.no_grad():
        gap = _mean_rel(got, f32(xt).numpy())
    assert BN_TOL < 0.5 * gap, (BN_TOL, gap)
    if train:
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, name).numpy(),
                np.asarray(m_ref["batch_stats"][key]), rtol=1e-6, atol=1e-6,
                err_msg=name)
            assert getattr(bn, name).dtype == torch.float32


def _state_before(v):
    return {"weight": torch.from_numpy(v["params"]["scale"]),
            "bias": torch.from_numpy(v["params"]["bias"]),
            "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
            "running_var": torch.from_numpy(v["batch_stats"]["var"]),
            "num_batches_tracked": torch.tensor(0)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_basic_block_matches_jax(train):
    """A stride-2 BasicBlock with its downsample (64 -> 128 channels) on a
    bf16 input [4, 16, 16, 64], perturbed scales and statistics: the bf16
    output against JAX's."""
    x = np.random.RandomState(8).randn(4, 16, 16, 64).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jb = JaxBasicBlock(128, strides=2, dtype=jnp.bfloat16)
    v = jb.init(jax.random.PRNGKey(1), xb, train=False)
    params = _randomize_bn_scales(v["params"], 3)
    stats = _randomize_stats(v["batch_stats"], 4)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, _ = jb.apply(variables, xb, train=True, mutable=["batch_stats"])
    else:
        ref = jb.apply(variables, xb, train=False)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)

    out = {}
    bridge._resnet(out, "r", {"layer2_block0": params},
                   {"layer2_block0": stats})
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).permute(
        0, 3, 1, 2).contiguous()
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        block = _load(BasicBlock(64, 128, 2), out, "r.layer2.0.")
        block.train(train)
        with torch.no_grad():
            res[dt] = block(xt.to(dt))
        assert res[dt].dtype == dt
    got = res[torch.bfloat16].float().numpy()
    err = _mean_rel(got, ref)
    gap = _mean_rel(got, res[torch.float32].numpy())
    assert err <= BLOCK_TOL, (err, gap)
    assert BLOCK_TOL < 0.5 * gap, (BLOCK_TOL, gap)


@pytest.mark.parametrize("depth", [18, 34])
def test_bf16_resnet_matches_jax(depth):
    """A bf16 ResNet in eval mode at batch 4, 32 x 32, with random running
    statistics: the fc output (float32) against JAX's, run op by op."""
    x = np.random.RandomState(8).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    make_j = jax_resnet18 if depth == 18 else jax_resnet34
    make_t = resnet18 if depth == 18 else resnet34
    jnet = make_j(num_classes=10, dtype=jnp.bfloat16)
    v = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 32, 32, 3)),
                                    train=False))(jax.random.PRNGKey(3))
    params = _np(v["params"])
    stats = _randomize_stats(v["batch_stats"], 10)
    ref = jnet.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x), train=False)
    assert ref.dtype == jnp.float32
    ref = np.asarray(ref)

    out = {}
    bridge._resnet(out, "r", params, stats)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        net = _load(make_t(num_classes=10, dtype=dt), out, "r.")
        seen = []
        net.layer4.register_forward_hook(
            lambda m, i, o: seen.append(o.dtype))
        with torch.no_grad():
            res[dt] = net(torch.from_numpy(x))
        assert seen == [dt] and res[dt].dtype == torch.float32
        for name, p in net.named_parameters():
            assert p.dtype == torch.float32, name
    got = res[torch.bfloat16].numpy()
    err = _mean_rel(got, ref)
    gap = _mean_rel(got, res[torch.float32].numpy())
    tol = RESNET_TOL[depth]
    assert err <= tol, (err, gap)
    assert tol < 0.5 * gap, (tol, gap)
