"""The port's chamfer (`shapeclipper_torch/ops/chamfer.py`, plain version on
the CPU) against the JAX package's `shapeclipper_tpu/ops/chamfer.py`.

Inputs are numpy draws from a seed, handed to both. The JAX side runs with
`SCL_CHAMFER_IMPL` set to 'pallas' (the Pallas kernels K4 / K5 in interpret
mode) and to 'xla' (its default metric sweep). Tolerances as
tests/test_chamfer.py: rtol 1e-4, atol 1e-5 for distances and gradients;
argmin indices exactly equal (random normal clouds have no near-ties at
these sizes; the tie cases are built exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.ops import chamfer as jchamfer
from shapeclipper_torch.ops import chamfer as tchamfer

TOL = dict(rtol=1e-4, atol=1e-5)


def _clouds(seed, B, N1, N2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N1, 3).astype(np.float32),
            rng.randn(B, N2, 3).astype(np.float32))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(1, 600, 2100), (3, 57, 201)])
def test_dists_sq_matches_jax(impl, shape, monkeypatch):
    """The metric path: distances only, across tile boundaries (600 x 2,100)
    and a batch of small ragged clouds."""
    monkeypatch.setenv("SCL_CHAMFER_IMPL", impl)
    x1, x2 = _clouds(7, *shape)
    jd1, jd2 = jchamfer.chamfer_dists_sq(jnp.asarray(x1), jnp.asarray(x2))
    d1, d2 = tchamfer.chamfer_dists_sq(torch.from_numpy(x1),
                                       torch.from_numpy(x2))
    assert d1.shape == shape[:2] and d2.shape == (shape[0], shape[2])
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), **TOL)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_distance_sq_and_argmin_match_jax(impl, monkeypatch):
    monkeypatch.setenv("SCL_CHAMFER_IMPL", impl)
    x1, x2 = _clouds(9, 2, 600, 2100)
    want = jchamfer.chamfer_distance_sq(jnp.asarray(x1), jnp.asarray(x2))
    got = tchamfer.chamfer_distance_sq(torch.from_numpy(x1),
                                       torch.from_numpy(x2))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_identical_clouds_and_duplicates():
    """Identical clouds: distance 0, argmin = self. Duplicated points: the
    lowest index wins, as jnp.argmin in the JAX reference."""
    x1, _ = _clouds(3, 2, 90, 1)
    d1, d2, i1, i2 = tchamfer.chamfer_distance_sq(torch.from_numpy(x1),
                                                  torch.from_numpy(x1))
    assert float(d1.abs().max()) == 0.0 and float(d2.abs().max()) == 0.0
    np.testing.assert_array_equal(i1.numpy(), np.tile(np.arange(90), (2, 1)))
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())

    # x2 holds every point of x1 twice (blocks [0, 90) and [90, 180)) and
    # one point five times: the first copy is the nearest everywhere
    x2 = np.concatenate([x1, x1, np.repeat(x1[:, 4:5], 3, axis=1)], axis=1)
    got = tchamfer.chamfer_distance_sq(torch.from_numpy(x1),
                                       torch.from_numpy(x2))
    want = jchamfer.chamfer_distance_sq_reference(jnp.asarray(x1),
                                                  jnp.asarray(x2))
    np.testing.assert_array_equal(got[2].numpy(), np.tile(np.arange(90),
                                                          (2, 1)))
    np.testing.assert_array_equal(got[3].numpy(),
                                  np.tile(np.r_[np.arange(90), np.arange(90),
                                                [4, 4, 4]], (2, 1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_gradient_matches_jax(impl, monkeypatch):
    """The backward (gather + index_add_) against jax.grad through the JAX
    custom VJP, with unequal weights on the two directions."""
    monkeypatch.setenv("SCL_CHAMFER_IMPL", impl)
    x1, x2 = _clouds(4, 2, 40, 50)
    w1, w2 = np.random.RandomState(5).rand(2, 1, 1).astype(np.float32)

    def jloss(a, b):
        d1, d2, _, _ = jchamfer.chamfer_distance_sq(a, b)
        return (d1 * w1[0]).mean() + (d2 * w2[0]).mean()

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    a = torch.from_numpy(x1).requires_grad_(True)
    b = torch.from_numpy(x2).requires_grad_(True)
    d1, d2, _, _ = tchamfer.chamfer_distance_sq(a, b)
    ((d1 * float(w1[0, 0])).mean() + (d2 * float(w2[0, 0])).mean()).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jg[1]), **TOL)


def test_chamfer_distance_and_reference():
    """Chamfer-L1 = sqrt of the squared distances; the reference (one block
    at this size) equals the plain version in ragged chunks."""
    x1, x2 = _clouds(6, 2, 75, 61)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    l1, l2, i1, i2 = tchamfer.chamfer_distance(None, t1, t2)
    jl = jchamfer.chamfer_distance(None, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl[0]), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl[1]), **TOL)
    ref = tchamfer.chamfer_distance_sq_reference(t1, t2)
    d, idx = tchamfer.nn_plain(t1, t2, with_index=True, block=61 * 7)
    np.testing.assert_array_equal(d.numpy(), ref[0].numpy())
    np.testing.assert_array_equal(idx.numpy(), ref[2].numpy())
    np.testing.assert_array_equal(i1.numpy(), ref[2].numpy())
    np.testing.assert_array_equal(i2.numpy(), ref[3].numpy())


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="empty"):
        tchamfer.chamfer_dists_sq(x, torch.zeros(1, 0, 3))
    with pytest.raises(ValueError, match="batch"):
        tchamfer.chamfer_dists_sq(x, torch.zeros(2, 4, 3))
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        tchamfer.chamfer_dists_sq(x, torch.zeros(1, 4, 2))
    before = dict(tchamfer.KERNEL.launches)
    tchamfer.chamfer_dists_sq(x, x)
    assert tchamfer.KERNEL.launches == before   # the CPU takes the plain path


def _chunks(N2, splits):
    c = tchamfer.nn_chunk(N2, splits)
    return [(s * c, min((s + 1) * c, N2)) for s in range(splits)]


@pytest.mark.parametrize("B,N1,N2,split", [
    (1, 100_000, 100_000, False),   # the timing shape: today's schedule
    (1, 100_000, 2048, False),      # the evaluation's pred -> gt
    (1, 2048, 100_000, True),       # the evaluation's gt -> pred
    (3, 57, 20_001, True),          # ragged, batched
    (3, 257, 20_001, True),
    (2, 3000, 6005, True),
    (1, 2048, 1, False),            # N2 = 1
    (1, 2048, 3, False),            # N2 < 4
    (1, 1, 5, False),
    (1, 1, 4097, True),
])
def test_nn_splits(B, N1, N2, split):
    """The kernel's chunks of B's cloud (132 SMs, an H100): one where the
    row blocks fill the card, more where they do not; the chunks tile N2
    exactly, none empty, none below the minimum unless N2 is."""
    splits = tchamfer.nn_splits(B, N1, N2, 132)
    assert (splits > 1) == split
    chunks = _chunks(N2, splits)
    assert chunks[0][0] == 0 and chunks[-1][1] == N2
    assert all(a < b for a, b in chunks)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    if splits > 1:
        assert all(b - a >= tchamfer.NN_MIN_CHUNK for a, b in chunks[:-1])
        # the fewest chunks: one fewer gives under three blocks per SM
        row_blocks = B * -(-N1 // tchamfer.NN_ROWS_PER_BLOCK)
        assert (splits - 1) * row_blocks < 3 * 132
    if (B, N1, N2) == (1, 2048, 100_000):
        assert splits == 50 and chunks[0] == (0, 2000)   # 400 blocks


def test_nn_splits_never_leaves_a_chunk_empty():
    """Every cloud size up to 12,000 points, with one to 16 row blocks and
    a card of 132 or 16 SMs."""
    for sms in (132, 16):
        for N1 in (1, 300, 2048, 4096):
            for N2 in range(1, 12_001):
                splits = tchamfer.nn_splits(1, N1, N2, sms)
                c = tchamfer.nn_chunk(N2, splits)
                assert (splits - 1) * c < N2 <= splits * c, (sms, N1, N2)
