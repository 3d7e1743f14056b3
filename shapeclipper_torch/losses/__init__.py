"""Loss library (counterpart of `shapeclipper_tpu/losses/__init__.py`):
pure functions on static shapes.

`normal_loss`'s robust trim keeps the best (1 - tolerance) fraction of the
masked pixels by angular error with a full-size rank, as the JAX package
does: invalid pixels sort last (+inf key) and a per-element rank <
floor(n_valid * (1 - tol)) comparison selects the kept set. The rank uses
stable sorts (`jnp.argsort` is stable; torch's default sort is not), so tied
angles keep the same pixels on both sides. Norms are written as
sqrt(sum + tiny) so that their gradients stay finite at zero vectors.

Every loss is the global batch's, as the JAX package's single-controller
step computes it. A mean of per-sample terms needs nothing under data
parallelism (DDP's gradient mean is the global mean's gradient); the losses
that couple the samples of the batch (`normal_loss`'s trim and its
denominator, `cam_uniform_loss`'s sort, the trimmed `mse_loss` and
`iou_loss`) first gather their inputs over the ranks
(`parallel.gather_rows`, the identity in one process), so that every rank
computes the global value.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import gather_rows


def aggregate_loss(loss, weight=None):
    if weight is not None:
        loss = loss * weight
    return loss.mean()


def l1_loss(pred, label=0.0, weight=None):
    return aggregate_loss((pred - label).abs(), weight=weight)


def mse_loss(pred, label=0.0, weight=None, tolerance=0.0):
    if tolerance > 1e-5:
        assert pred.dim() == 3 and pred.shape[2] in (1, 3)
        assert weight is None
        pred = gather_rows(pred)
        if torch.is_tensor(label) and label.dim() == pred.dim():
            label = gather_rows(label)
    loss = (pred - label) ** 2
    if tolerance > 1e-5:
        loss_pixel = (loss.mean(dim=2).reshape(-1) if pred.shape[2] == 3
                      else loss.reshape(-1))
        loss_sorted = torch.sort(loss_pixel, stable=True).values
        end_idx = int((1 - tolerance) * loss_pixel.shape[0])
        return loss_sorted[:end_idx].mean()
    return aggregate_loss(loss, weight=weight)


def ce_loss(logits, labels, weight=None):
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return aggregate_loss(nll, weight=weight)


def bce_loss(pred, label, weight=None, tolerance=0.0, eps=1e-7):
    pred = pred.clamp(eps, 1 - eps)
    label = torch.as_tensor(label, dtype=pred.dtype,
                            device=pred.device).expand(pred.shape)
    loss = -(label * torch.log(pred) + (1 - label) * torch.log(1 - pred))
    if tolerance > 1e-5:
        loss_pixel = loss.reshape(pred.shape[0], -1)
        loss_sorted = torch.sort(loss_pixel, dim=-1, stable=True).values
        end_idx = int((1 - tolerance) * loss_pixel.shape[1])
        return aggregate_loss(loss_sorted[:, :end_idx], weight=weight)
    return aggregate_loss(loss, weight=weight)


def normal_loss(normal_pred, normal_gt, mask, normal_l1=5.0, weight=None,
                tolerance=0.0):
    """normal_l1 * L1 + (1 - cos) on masked pixels, robust-trimmed by
    angular error. normal_pred / gt [B, R, 3]; mask [B, R] or [B, R, 1]
    bool."""
    if mask.dim() == 3:
        mask = mask[..., 0]
    assert normal_pred.shape == normal_gt.shape and normal_pred.dim() == 3
    normal_pred, normal_gt, mask = (gather_rows(normal_pred),
                                    gather_rows(normal_gt), gather_rows(mask))
    if torch.is_tensor(weight):
        weight = gather_rows(weight)
    maskf = mask.to(normal_pred.dtype)
    angular = 1.0 - (normal_pred * normal_gt).sum(dim=-1)
    l1 = (normal_pred - normal_gt).abs().sum(dim=-1)
    loss = normal_l1 * l1 + angular                             # [B, R]

    flat_loss = loss.reshape(-1)
    flat_mask = maskf.reshape(-1)
    n_valid = flat_mask.sum()
    key = torch.where(flat_mask > 0, angular.reshape(-1).detach(),
                      torch.full_like(flat_loss, math.inf))
    order = torch.argsort(key, stable=True)
    ranks = torch.argsort(order, stable=True)
    keep_count = torch.floor(n_valid * (1.0 - tolerance))
    keep = (ranks < keep_count).to(flat_loss.dtype) * flat_mask
    if weight is not None:
        # per-sample weights arrive as [B, 1, 1]; drop trailing axes beyond
        # the loss's [B, R] rank before broadcasting
        w = torch.as_tensor(weight)
        while w.dim() > loss.dim():
            w = w[..., 0]
        flat_loss = flat_loss * w.expand(loss.shape).reshape(-1)
    denom = keep.sum().clamp(min=1.0)
    return (flat_loss * keep).sum() / denom


def iou_loss(inputs, targets, weight=None, tolerance=0.0):
    """Soft IoU with optional outlier replacement."""
    if tolerance > 1e-5:
        inputs, targets = gather_rows(inputs), gather_rows(targets)
    batch_size = inputs.shape[0]
    x = inputs.reshape(batch_size, -1)
    y = targets.reshape(batch_size, -1)
    if tolerance > 1e-5:
        assert weight is None
        diff = (x - y).abs().reshape(-1)
        idx_sorted = torch.argsort(diff.detach(), stable=True)
        end_idx = int((1 - tolerance) * diff.shape[0])
        idx_outlier = idx_sorted[end_idx:]
        x_flat = x.reshape(-1).clone()
        x_flat[idx_outlier] = y.reshape(-1)[idx_outlier]
        x = x_flat.reshape(batch_size, -1)
    inter = (x * y).sum(dim=1)
    union = (x + y - x * y + 1e-8).sum(dim=1)
    loss = 1.0 - inter / union
    if weight is not None:
        loss = loss * weight.reshape(batch_size)
    return loss.mean()


def mask_loss(inputs, targets, mask_mse=0.0, weight=None, tolerance=0.0):
    loss = iou_loss(inputs, targets, weight=weight, tolerance=tolerance)
    if mask_mse:
        loss = loss + mask_mse * mse_loss(inputs, targets, weight=weight,
                                          tolerance=tolerance)
    return loss


def cam_margin(trig, ranges, eps=5.0):
    """Hinge on the angle (degrees) outside [ranges[0], ranges[1]]."""
    assert ranges[0] > -180 and ranges[1] < 180
    angle = torch.atan2(trig[:, 1], trig[:, 0]) * 180.0 / math.pi
    lo = torch.clamp(-angle + ranges[0] - eps, min=0.0)
    hi = torch.clamp(angle - ranges[1] - eps, min=0.0)
    return lo.mean() + hi.mean()


def cam_margin_loss(opt, trig_elev, trig_theta):
    ranges = opt.data[opt.data.dataset]
    return (cam_margin(trig_elev, ranges.elev_range)
            + cam_margin(trig_theta, ranges.theta_range))


def cam_sym_loss(trig_orig, trig_flipped):
    """Flip-consistency: azim / theta negate, elev invariant. trig_* are
    (azim, elev, theta) tuples of [B, 2] (cos, sin)."""
    (a, e, t), (af, ef, tf) = trig_orig, trig_flipped
    loss_azim = (a[:, 0] - af[:, 0]) ** 2 + (-a[:, 1] - af[:, 1]) ** 2
    loss_elev = (e[:, 0] - ef[:, 0]) ** 2 + (e[:, 1] - ef[:, 1]) ** 2
    loss_theta = (t[:, 0] - tf[:, 0]) ** 2 + (-t[:, 1] - tf[:, 1]) ** 2
    return loss_azim.mean() + loss_elev.mean() + loss_theta.mean()


def cam_uniform_loss(trig, emd_p=2):
    """1-D Wasserstein between the batch's azimuth trig statistics and a
    uniform circle prior."""
    trig = gather_rows(trig)
    batch_size = trig.shape[0]
    cos_e, sin_e = trig[:, 0], trig[:, 1]
    prod_e = cos_e * sin_e
    grid = (torch.arange(1.0, 2 * batch_size, 2.0, device=trig.device)
            * math.pi / batch_size)
    cos_p, sin_p = torch.cos(grid), torch.sin(grid)
    prod_p = cos_p * sin_p
    dists = [torch.sort(p, stable=True).values
             - torch.sort(e, stable=True).values
             for p, e in ((cos_p, cos_e), (sin_p, sin_e), (prod_p, prod_e))]
    if emd_p == 1:
        return sum(d.abs().mean() for d in dists) / 3.0
    if emd_p == 2:
        # sqrt(sum^2 + tiny): a finite gradient at d == 0
        return sum(torch.sqrt((d ** 2).sum() + 1e-24)
                   for d in dists) / (3.0 * batch_size)
    return sum(torch.linalg.vector_norm(d, ord=emd_p)
               for d in dists) / (3.0 * batch_size)


def category_reg_loss(proj_latent_sdf, shape_centers, category_labels,
                      temperature=0.3):
    """InfoNCE-style CE of normalized shape codes vs per-category centers."""
    def _nrm(x, eps=1e-12):  # a finite gradient at x == 0
        sq = (x * x).sum(dim=-1, keepdim=True)
        return x / torch.sqrt(torch.clamp(sq, min=eps * eps))

    logits = _nrm(proj_latent_sdf) @ _nrm(shape_centers).t()
    return ce_loss(logits / temperature, category_labels)
