"""Dataset base + host-side batch loader (a copy of
`shapeclipper_tpu/data/base.py`, which is numpy only; the port keeps its own
copy so that it never imports the JAX package).

A thread-pool loader producing stacked numpy batches; sharding slices the
index space by (shard_id, num_shards) instead of a DistributedSampler, and
a batch-level shard (batch_shard_id, num_batch_shards) hands a rank whole
batches of the unsharded sequence.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np


def _warp_rot_zoom(img, theta, zoom, cval):
    """Center rotate+zoom an [H,W,C] float map: output pixel p samples input
    at c + zoom*R(theta)@(p-c) (bilinear; constant `cval` outside)."""
    from scipy import ndimage
    H, W = img.shape[:2]
    c, s = np.cos(theta), np.sin(theta)
    A = np.array([[c, -s], [s, c]], np.float64) * zoom
    center = np.array([(H - 1) / 2.0, (W - 1) / 2.0])
    offset = center - A @ center
    out = [ndimage.affine_transform(img[..., k].astype(np.float64), A,
                                    offset=offset, order=1,
                                    mode="constant", cval=cval)
           for k in range(img.shape[-1])]
    return np.stack(out, -1).astype(np.float32)


def default_collate(samples):
    """Stack a list of dict samples (values: np arrays / scalars / dicts)."""
    out = {}
    for key in samples[0]:
        v0 = samples[0][key]
        if isinstance(v0, dict):
            out[key] = default_collate([s[key] for s in samples])
        else:
            out[key] = np.stack([np.asarray(s[key]) for s in samples], axis=0)
    return out


class Dataset:
    def __init__(self, opt, split):
        self.opt = opt.deepcopy() if hasattr(opt, "deepcopy") else opt
        self.split = split
        self.augment = (split == "train" and opt.data.get("augment"))
        if self.augment:
            # fail fast with a clear message instead of an ImportError at
            # the first training batch (scipy is an optional dependency,
            # needed only by the rotate/zoom warp in apply_augmentation)
            try:
                from scipy import ndimage  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "data.augment requires scipy (pip install scipy / the "
                    "'full' extra); the rotate/zoom warp uses "
                    "scipy.ndimage.affine_transform") from e

    # ------------------------------------------------------ augmentation
    def generate_augmentation(self, opt, rng=None):
        """Per-sample augmentation parameters (reference
        `data/base.py:41-58`): color jitter ranges, horizontal flip, crop
        ratio, rotation angle."""
        rng = rng or np.random
        aug = opt.data.augment
        return dict(
            brightness=1 + (rng.rand() * 2 - 1) * (aug.get("brightness") or 0),
            contrast=1 + (rng.rand() * 2 - 1) * (aug.get("contrast") or 0),
            saturation=1 + (rng.rand() * 2 - 1) * (aug.get("saturation") or 0),
            hue=(rng.rand() * 2 - 1) * (aug.get("hue") or 0),
            flip=bool(rng.randn() > 0) if aug.get("hflip") else False,
            crop_ratio=(1 + (rng.rand() * 2 - 1) * aug.crop_scale
                        if aug.get("crop_scale") else 1),
            rot_angle=((rng.rand() * 2 - 1) * aug.rotate
                       if aug.get("rotate") else 0),
        )

    def apply_color_jitter(self, rgb, aug):
        """rgb: [H, W, 3] float in [0,1] -> jittered (brightness/contrast/
        saturation/hue), host-side numpy."""
        x = np.asarray(rgb, np.float32)
        x = np.clip(x * aug["brightness"], 0, 1)
        mean = x.mean(axis=(0, 1), keepdims=True)
        x = np.clip((x - mean) * aug["contrast"] + mean, 0, 1)
        grey = x.mean(axis=-1, keepdims=True)
        x = np.clip((x - grey) * aug["saturation"] + grey, 0, 1)
        if aug["hue"]:
            # cheap hue rotation via channel roll interpolation
            rolled = np.roll(x, 1, axis=-1)
            t = abs(aug["hue"])
            x = np.clip((1 - t) * x + t * rolled, 0, 1)
        return x

    # The reference generates flip/crop_ratio/rot_angle params
    # (`data/base.py:41-58`) and provides the crop helper
    # (`data/pix3d.py:317-326`); this apply path makes every generated knob
    # effective on the resized float maps, keeping ray sampling consistent
    # (augmentation runs BEFORE the distance-transform ray sampler, so
    # ray_idx is always drawn from the augmented mask).
    def apply_augmentation(self, opt, rgb, mask, normal, aug):
        """Apply a generated `aug` dict to ([H,W,3], [H,W,1], [H,W,3]) maps:
        color jitter on rgb, horizontal flip, and a combined center
        rotate+zoom warp (crop_ratio>1 zooms out with background padding,
        matching the reference's `square_crop` S2=S*crop_ratio semantics).
        Flip negates the normal's x component; rotation rotates the in-plane
        (x,y) normal components with the image content."""
        rgb = self.apply_color_jitter(rgb, aug)
        if aug["flip"]:
            rgb, mask, normal = rgb[:, ::-1], mask[:, ::-1], normal[:, ::-1]
            normal = normal * np.array([-1.0, 1.0, 1.0], np.float32)
        if aug["rot_angle"] or aug["crop_ratio"] != 1:
            th = np.deg2rad(aug["rot_angle"])
            bg = float(opt.data.bgcolor or 0.0)
            rgb = _warp_rot_zoom(rgb, th, aug["crop_ratio"], bg)
            mask = (_warp_rot_zoom(mask, th, aug["crop_ratio"], 0.0)
                    > 0.5).astype(np.float32)
            c, s = np.cos(th), np.sin(th)
            nx, ny = normal[..., 0], normal[..., 1]
            normal = np.stack([c * nx - s * ny, s * nx + c * ny,
                               normal[..., 2]], -1)
            normal = _warp_rot_zoom(normal, th, aug["crop_ratio"], 0.0)
            nrm = np.linalg.norm(normal, axis=-1, keepdims=True)
            normal = normal / np.maximum(nrm, 1e-8) * mask
        return (np.ascontiguousarray(rgb, np.float32),
                np.ascontiguousarray(mask, np.float32),
                np.ascontiguousarray(normal, np.float32))

    def augment_mask2d(self, mask2d, aug):
        """Geometric part only, on a [H,W] mask (the preselect-NN path draws
        ray indices from the neighbor mask before the full load — this keeps
        those indices consistent with the later-augmented maps)."""
        m = np.asarray(mask2d, np.float32)
        if aug["flip"]:
            m = m[:, ::-1]
        if aug["rot_angle"] or aug["crop_ratio"] != 1:
            th = np.deg2rad(aug["rot_angle"])
            m = (_warp_rot_zoom(m[..., None], th, aug["crop_ratio"], 0.0)
                 [..., 0] > 0.5).astype(np.float32)
        return np.ascontiguousarray(m)

    def augment_pose(self, pose, aug):
        """GT-pose consistency (vis overlays only at train time): horizontal
        flip conjugates the rotation by M=diag(-1,1,1) — exactly the
        azim->-azim, theta->-theta, elev-invariant convention of the
        reference's cam_sym loss (`model/loss.py:113-132`); in-plane image
        rotation pre-multiplies a camera roll. The z-only translation is
        invariant under both."""
        R, t = np.asarray(pose[:, :3], np.float32), pose[:, 3:]
        if aug["flip"]:
            M = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
            R = M @ R @ M
        if aug["rot_angle"]:
            th = np.deg2rad(aug["rot_angle"])
            c, s = np.cos(th), np.sin(th)
            Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            R = Rz @ R
        return np.concatenate([R, np.asarray(t, np.float32)], axis=1)

    def __len__(self):
        return len(self.list)

    def __getitem__(self, idx):
        raise NotImplementedError

    def setup_loader(self, opt, shuffle=False, drop_last=True, batch_size=None,
                     shard_id=0, num_shards=1, seed=0, batch_shard_id=0,
                     num_batch_shards=1):
        batch_size = batch_size or opt.batch_size
        return DataLoader(self, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last,
                          num_workers=opt.data.get("num_workers", 4) or 0,
                          shard_id=shard_id, num_shards=num_shards, seed=seed,
                          worker_type=opt.data.get("worker_type") or "thread",
                          batch_shard_id=batch_shard_id,
                          num_batch_shards=num_batch_shards)


def select_nn_views(opt, query_mask_sampled, nn_masks_sampled, rng):
    """Host-side IoU-weighted sampling (without replacement) of
    reg.n_views of the k neighbors — identical scoring to the in-graph
    selection (reference `model/graph.py:119-142`). With data.preselect_NN
    the pipeline loads/ships ONLY the selected views (the reference loads
    and uploads all k and selects on device)."""
    q = np.asarray(query_mask_sampled, np.float32).reshape(-1)
    ious = []
    for m in nn_masks_sampled:
        m = np.asarray(m, np.float32).reshape(-1)
        inter = (m * q).sum()
        union = (m + q - m * q + 1e-8).sum()
        ious.append(inter / union)
    scores = (1.0 - np.asarray(ious)) ** opt.reg.sample_temp
    total = scores.sum()
    if total <= 0:
        probs = np.full(len(ious), 1.0 / len(ious))
    else:
        probs = scores / total
    rng = rng or np.random
    return rng.choice(len(ious), size=opt.reg.n_views, replace=False, p=probs)


_FORK_DATASET = None


def _raise_nofile_limit(target: int = 2048):
    """Best-effort soft RLIMIT_NOFILE raise before spawning worker
    processes (the reference does this at runner import to survive
    many-worker loaders, `model/runner.py:8-9`)."""
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < target:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(target, hard), hard))
    except (ImportError, ValueError, OSError):
        pass


def _fork_init(ds):
    global _FORK_DATASET
    _FORK_DATASET = ds


def _fork_get(i):
    return _FORK_DATASET[int(i)]


class DataLoader:
    """Epoch-based loader: shuffles indices, loads samples with a worker pool,
    prefetches collated batches on a background thread.

    `worker_type='thread'` (default) uses a GIL-sharing thread pool;
    `'process'` forks a ProcessPoolExecutor (the reference used 12 worker
    processes, `data/base.py:16-30` + `options/pix3d/config.yaml`) — the
    right choice when per-sample work is numpy/decode-bound and cores are
    plentiful. Chosen via `opt.data.worker_type`; measured by
    `scripts/bench_loader.py`.

    Two shards. (shard_id, num_shards) splits the rows: shard r loads
    positions r, r + W, ... of every global batch (training). The batch
    shard (batch_shard_id, num_batch_shards) splits whole batches: shard r
    loads batches r, r + W, ... of the unsharded sequence and never builds
    the others (evaluation); `indexed()` pairs each with its index in that
    sequence."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=True,
                 num_workers=4, shard_id=0, num_shards=1, seed=0,
                 prefetch=2, worker_type="thread", batch_shard_id=0,
                 num_batch_shards=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 0)
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.worker_type = worker_type
        self.batch_shard_id = batch_shard_id
        self.num_batch_shards = num_batch_shards

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _epoch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last and self.num_shards > 1:
            # whole global batches only: every shard gets the same number
            # of batches, and batch k of the shards together is batch k of
            # one process at the global batch size
            glob = self.batch_size * self.num_shards
            idx = idx[:len(idx) - len(idx) % glob]
        idx = idx[self.shard_id::self.num_shards]
        return idx

    def _num_batches(self):
        """Batches of the sequence before the batch shard."""
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_numbers(self):
        return range(self.batch_shard_id, self._num_batches(),
                     self.num_batch_shards)

    def __len__(self):
        return len(self._batch_numbers())

    def __iter__(self):
        return (batch for _, batch in self.indexed())

    def indexed(self):
        """(k, batch) for each batch of this shard, k its index in the
        sequence before the batch shard."""
        indices = self._epoch_indices()
        numbers = list(self._batch_numbers())
        batches = [indices[k * self.batch_size:(k + 1) * self.batch_size]
                   for k in numbers]

        if self.num_workers == 0:
            for k, b in zip(numbers, batches):
                yield k, default_collate([self.dataset[int(i)] for i in b])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def make_pool():
            if self.worker_type == "process":
                import multiprocessing as mp
                _raise_nofile_limit()
                return ProcessPoolExecutor(
                    self.num_workers, mp_context=mp.get_context("fork"),
                    initializer=_fork_init, initargs=(self.dataset,))
            return ThreadPoolExecutor(self.num_workers)

        def producer():
            get = (_fork_get if self.worker_type == "process"
                   else self.dataset.__getitem__)
            with make_pool() as pool:
                for k, b in zip(numbers, batches):
                    if stop.is_set():
                        return
                    samples = list(pool.map(get, [int(i) for i in b]))
                    q.put((k, default_collate(samples)))
            q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
            # Unblock a producer stuck in q.put so it reaches the stop check
            # and shuts its pool down — abandoning an iterator mid-epoch must
            # not leak worker threads/processes. Drain until the producer
            # thread actually exits: a single drain can race a blocked
            # q.put, leaving one final batch referenced in the queue.
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
