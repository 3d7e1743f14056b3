"""Brute-force bidirectional nearest-neighbour (Chamfer) distances: the plain
PyTorch version and the wrapper of the Hopper kernel `csrc/chamfer.cu`
(counterpart of `shapeclipper_tpu/ops/chamfer.py`).

  * `chamfer_dists_sq` (the metric path): squared NN distances in both
    directions, no indices, no gradient. On CUDA one launch of K4 (the
    distance-only instantiation) per direction.
  * `chamfer_distance_sq`: distances and argmin indices in both directions,
    differentiable in the points. On CUDA one launch of K5 (the argmin
    instantiation) per direction, inside a `torch.autograd.Function` whose
    backward is the JAX package's `_chamfer_bwd`: a gather and an
    `index_add_` (segment sum), plain torch.
  * `chamfer_distance`: their square roots (Chamfer-L1).
  * `chamfer_distance_sq_reference`: the plain version in both directions,
    with indices (the JAX package's API; autograd differentiates it).
CPU tensors take the plain version (`nn_plain`: the exact form
(a-b)^2 summed per coordinate, in chunks of rows so that memory stays
bounded). CUDA tensors launch the kernel or raise; there is no fallback.
Where A has too few rows to fill the card, the kernel splits B's cloud into
`nn_splits` chunks swept by separate blocks and combined exactly (bitwise
the unsplit result).
Ties go to the lowest index everywhere, as `jnp.argmin` and `torch.argmin`.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .cuda_lib import BUILD_DIR, CSRC_DIR, CudaLibrary

_SOURCE = os.path.join(CSRC_DIR, "chamfer.cu")

# elements of one [rows, N2] distance block of the plain version
PLAIN_BLOCK = 1 << 22
# rows of A that one block of the kernel owns (`kRowsPerBlock`)
NN_ROWS_PER_BLOCK = 256
# fewest points of B in a chunk when the kernel splits B's cloud: half a
# shared-memory tile, a multiple of 4
NN_MIN_CHUNK = 1024


def nn_plain(x1, x2, with_index=False, block=None):
    """x1 [B,N1,3], x2 [B,N2,3] -> (dist [B,N1], idx [B,N1] int32 or None):
    for each point of x1 the squared distance to its nearest point of x2,
    ((ax-bx)^2 + (ay-by)^2) + (az-bz)^2, and the first index attaining it."""
    B, N1, _ = x1.shape
    N2 = x2.shape[1]
    block = block or PLAIN_BLOCK
    rows = max(1, block // max(N2, 1))
    dist = torch.empty(B, N1, device=x1.device, dtype=x1.dtype)
    idx = (torch.empty(B, N1, device=x1.device, dtype=torch.int32)
           if with_index else None)
    bt = x2[:, None, :, :]                                   # [B,1,N2,3]
    for start in range(0, N1, rows):
        a = x1[:, start:start + rows, None, :]               # [B,r,1,3]
        d = ((a[..., 0] - bt[..., 0]) ** 2 + (a[..., 1] - bt[..., 1]) ** 2
             + (a[..., 2] - bt[..., 2]) ** 2)                 # [B,r,N2]
        if with_index:
            m, i = torch.min(d, dim=2)
            dist[:, start:start + rows] = m
            idx[:, start:start + rows] = i.to(torch.int32)
        else:
            dist[:, start:start + rows] = d.amin(dim=2)
    return dist, idx


def nn_chunk(N2, splits):
    """Points of B in each of `splits` chunks, as the kernel cuts B's cloud:
    ceil(N2 / splits) rounded up to a multiple of 4; the last chunk holds
    the rest."""
    return (-(-N2 // splits) + 3) // 4 * 4


def nn_splits(B, N1, N2, sms):
    """How many chunks the kernel splits B's cloud into (its grid dimension
    y) for A [B,N1,3] against B [B,N2,3] on a card with `sms` SMs. One where
    the blocks of 256 rows of A already give about two blocks per SM;
    otherwise the fewest chunks that give about three, but no more than
    N2 // `NN_MIN_CHUNK`, so that every chunk but the last holds at least
    that many points. Every chunk holds at least one point: S = ceil(N2 / c)
    for a multiple of 4 c, so nn_chunk(N2, S) <= c and (S - 1) c < N2."""
    blocks = B * -(-N1 // NN_ROWS_PER_BLOCK)
    if blocks >= 2 * sms:
        return 1
    want = min(-(-3 * sms // blocks), N2 // NN_MIN_CHUNK)
    return -(-N2 // nn_chunk(N2, max(1, want)))


class ChamferKernel(CudaLibrary):
    """The chamfer library (K4 / K5, `csrc/chamfer.cu`). `launches` counts
    launches of each instantiation ('dist' = K4, 'argmin' = K5), one per
    direction; it is incremented where the kernel is launched and nowhere
    else."""

    stem = "scl_chamfer"
    source = _SOURCE

    def __init__(self, build_dir=BUILD_DIR):
        super().__init__(build_dir)
        self.launches = {"dist": 0, "argmin": 0}

    def _bind(self, lib):
        fn = lib.scl_chamfer_nn
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def launch(self, x1, x2, with_index, splits=None):
        """x1 [B,N1,3], x2 [B,N2,3] (float32, contiguous, one CUDA device)
        -> (dist [B,N1] float32, idx [B,N1] int32 or None). `splits`: the
        chunks of x2's cloud, `nn_splits`'s choice when None (1 sweeps it
        whole in every block)."""
        lib = self.build()
        B, N1, _ = x1.shape
        N2 = x2.shape[1]
        dev = x1.device
        if splits is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits = nn_splits(B, N1, N2, sms)
        if not 1 <= splits <= 65535:
            raise ValueError(f"splits must be in [1, 65535], got {splits}")
        with torch.cuda.device(dev):
            # with a split, blocks combine by atomicMin into +inf distances
            # (K4) or all-ones 64-bit keys (K5), filled on this stream
            dist = (torch.full((B, N1), float("inf"), device=dev,
                               dtype=torch.float32)
                    if splits > 1 and not with_index else
                    torch.empty(B, N1, device=dev, dtype=torch.float32))
            idx = (torch.empty(B, N1, device=dev, dtype=torch.int32)
                   if with_index else None)
            key = (torch.full((B, N1), -1, device=dev, dtype=torch.int64)
                   if splits > 1 and with_index else None)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.scl_chamfer_nn(
                x1.data_ptr(), x2.data_ptr(), dist.data_ptr(),
                idx.data_ptr() if with_index else None,
                key.data_ptr() if key is not None else None, B, N1, N2,
                splits, stream)
        if err != 0:
            raise RuntimeError(f"chamfer kernel launch failed: cudaError "
                               f"{err}")
        self.launches["argmin" if with_index else "dist"] += 1
        return dist, idx


KERNEL = ChamferKernel()


def _check_clouds(x1, x2):
    for name, x in (("x1", x1), ("x2", x2)):
        if x.dim() != 3 or x.shape[-1] != 3:
            raise ValueError(f"{name} must be [B, N, 3], got {tuple(x.shape)}")
        if x.shape[1] == 0:
            raise ValueError(f"{name} is an empty cloud")
    if x1.shape[0] != x2.shape[0]:
        raise ValueError(f"batch sizes differ: {x1.shape[0]} vs "
                         f"{x2.shape[0]}")
    if x1.device != x2.device:
        raise ValueError(f"x1 is on {x1.device}, x2 on {x2.device}")
    if x1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no chamfer path for device {x1.device}")
    if x1.device.type == "cuda":
        for name, x in (("x1", x1), ("x2", x2)):
            if x.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def _nn(x1, x2, with_index):
    if x1.device.type == "cpu":
        return nn_plain(x1, x2, with_index)
    return KERNEL.launch(x1, x2, with_index)


def chamfer_dists_sq(x1, x2):
    """x1 [B,N1,3], x2 [B,N2,3] -> (dist1 [B,N1], dist2 [B,N2]): squared
    NN distances in both directions, no indices (the metric path)."""
    _check_clouds(x1, x2)
    with torch.no_grad():
        return _nn(x1, x2, False)[0], _nn(x2, x1, False)[0]


class _ChamferDistanceSq(torch.autograd.Function):
    """K5 in both directions; the backward is `_chamfer_bwd`'s gather +
    segment sum: d1_i = |x1_i - x2_{i1_i}|^2 gives dx1_i += 2 g1_i
    (x1_i - x2_{i1_i}) and the opposite to x2 at i1_i, and symmetrically
    for direction 2."""

    @staticmethod
    def forward(ctx, x1, x2):
        d1, i1 = _nn(x1, x2, True)
        d2, i2 = _nn(x2, x1, True)
        ctx.save_for_backward(x1, x2, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        x1, x2, i1, i2 = ctx.saved_tensors
        i1, i2 = i1.long(), i2.long()
        diff1 = x1 - torch.gather(x2, 1, i1[..., None].expand(-1, -1, 3))
        diff2 = x2 - torch.gather(x1, 1, i2[..., None].expand(-1, -1, 3))
        seg1 = 2.0 * g1[..., None] * diff1                    # [B,N1,3]
        seg2 = 2.0 * g2[..., None] * diff2                    # [B,N2,3]
        B, N1, N2 = x1.shape[0], x1.shape[1], x2.shape[1]
        rows = torch.arange(B, device=x1.device)[:, None]
        dx1, dx2 = seg1.clone(), seg2.clone()
        # segment sums over the flattened batch: row b's indices offset by b*N
        dx2.view(B * N2, 3).index_add_(0, (i1 + rows * N2).reshape(-1),
                                       -seg1.reshape(-1, 3))
        dx1.view(B * N1, 3).index_add_(0, (i2 + rows * N1).reshape(-1),
                                       -seg2.reshape(-1, 3))
        return dx1, dx2


def chamfer_distance_sq(x1, x2):
    """x1 [B,N1,3], x2 [B,N2,3] -> (dist1 [B,N1], dist2 [B,N2],
    idx1 [B,N1] int32, idx2 [B,N2] int32): squared NN distances and the
    nearest points' indices in both directions, differentiable in x1, x2."""
    _check_clouds(x1, x2)
    return _ChamferDistanceSq.apply(x1, x2)


def chamfer_distance_sq_reference(x1, x2):
    """`chamfer_distance_sq` through the plain version on any device."""
    d1, i1 = nn_plain(x1, x2, True)
    d2, i2 = nn_plain(x2, x1, True)
    return d1, d2, i1, i2


def chamfer_distance(opt, X1, X2):
    """Chamfer-L1: square roots of `chamfer_distance_sq`'s distances, with
    its indices."""
    d1, d2, i1, i2 = chamfer_distance_sq(X1, X2)
    return torch.sqrt(d1), torch.sqrt(d2), i1, i2
