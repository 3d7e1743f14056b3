"""The reference's training step and request, built from `model.py`.

`train_step` is one full step of ShapeClipper's training (train-mode
BatchNorm, every loss of the configuration, Adam over every parameter) on
a batch with one CLIP nearest-neighbour view a sample: the query and the
view encoded and posed, both rendered with the query's SDF latent, the
eikonal points of the query, the losses, the gradients and the Adam
update. The render's backward runs in blocks of views, so that the SDF
MLP's activations and tangents fit on the card: the render outputs are
computed once without a graph, the losses are differentiated with respect
to them, and each block is rendered again with a graph and back-propagated
with its share of that cotangent.

`request` is one single-image reconstruction: eval-mode BatchNorm, the
latents and pose, the eval render, the SDF grid and turntable views.
"""

from __future__ import annotations

import torch

from . import model as M


def forward_encoders(P, cfg, batch, prec):
    """Train-mode encoders, projections and estimator of the query, its
    flipped copy (cam_sym) and its neighbour view, each view group with its
    own BatchNorm moments."""
    H, W = cfg["image_size"]
    q_img, n_img = batch["rgb_input_map"], batch["rgb_input_map_NN"][:, 0]
    lat_sdf, lat_rgb = M.encode(P, cfg, q_img, True, prec)
    _, lat_rgb_nn = M.encode(P, cfg, n_img, True, prec)
    est = M.estimator(P, cfg, q_img, True, prec)
    est_flip = M.estimator(P, cfg, q_img.flip(2), True, prec)
    est_nn = M.estimator(P, cfg, n_img, True, prec)
    pose, intr = M.pose_and_intr(cfg, est, H, W)
    pose_nn, intr_nn = M.pose_and_intr(cfg, est_nn, H, W)
    return dict(lat_sdf=lat_sdf, lat_rgb=lat_rgb, lat_rgb_nn=lat_rgb_nn,
                est=est, est_flip=est_flip, est_nn=est_nn, pose=pose,
                intr=intr, pose_nn=pose_nn, intr_nn=intr_nn)


def _render_group(P, cfg, inputs, rows, prec):
    H, W = cfg["image_size"]
    return M.render(P, cfg, inputs["pose"][rows], inputs["intr"][rows],
                    inputs["scale"][rows], inputs["lat_sdf"][rows],
                    inputs["lat_rgb"][rows], H, W, prec,
                    ray_idx=inputs["ray_idx"][rows],
                    t_rand=inputs["t_rand"][rows])


def eikonal_norms(P, cfg, pose, intr, scale, lat_sdf, ray_idx, t_rand,
                  eik_idx, eik_uniform, prec):
    """|d sdf / d x| at the eikonal points: eik_uniform [B, R, 3] and one
    jittered depth sample a query ray; the latent detached."""
    H, W = cfg["image_size"]
    centre, ray = M.rays(pose, intr, H, W, ray_idx)
    z = M.z_values(cfg, scale, ray.shape[1], t_rand)
    z_eik = torch.gather(z, -1, eik_idx.long())
    near = centre + z_eik * M.unit(ray)
    pts = torch.cat([eik_uniform, near], 1)
    _, _, grad = M.sdf_field(P, cfg, pts, lat_sdf.detach(), prec)
    return torch.sqrt(torch.clamp((grad * grad).sum(-1), min=1e-24))


def losses(cfg, batch, enc, out_q, out_n, eik):
    """Every loss term of the configuration -> ({name: value}, weighted
    sum)."""
    lw, reg = cfg["loss_weight"], cfg["reg"]
    ranges = cfg["data"][cfg["data"]["dataset"]]
    mask_in, mask_nn = batch["mask_input"], batch["mask_input_NN"][:, 0]
    terms = dict(
        render=M.mse(out_q.rgb, batch["rgb_input"]),
        mask=M.iou_loss(out_q.mask, mask_in),
        normal=M.normal_loss(
            out_q.normal, M.to_canonical(batch["normal_input"], enc["pose"]),
            (mask_in[..., 0] > 0.5) & (out_q.mask[..., 0] > 0.5),
            reg["normal_l1"], reg["normal_tol"]),
        eikonal=M.mse(eik, 1.0),
        cam_margin=(M.cam_margin(enc["est"].trig_elev, ranges["elev_range"])
                    + M.cam_margin(enc["est"].trig_theta,
                                   ranges["theta_range"])),
        cam_uniform=M.cam_uniform(enc["est"].trig_azim),
        cam_sym=M.cam_sym(enc["est"], enc["est_flip"]),
        nearest_img=M.mse(out_n.rgb, batch["rgb_input_NN"][:, 0]),
        nearest_mask=M.iou_loss(out_n.mask, mask_nn),
        nearest_normal=M.normal_loss(
            out_n.normal,
            M.to_canonical(batch["normal_input_NN"][:, 0], enc["pose_nn"]),
            (mask_nn[..., 0] > 0.5) & (out_n.mask[..., 0] > 0.5),
            reg["normal_l1"], reg["normal_tol"]))
    terms = {k: v for k, v in terms.items() if lw.get(k) is not None}
    return terms, sum(float(lw[k]) * v for k, v in terms.items())


def loss_and_grads(P, cfg, batch, draws, prec, block=4):
    """The step's loss and the gradient of every parameter in `P` that
    requires one."""
    B = batch["rgb_input_map"].shape[0]
    enc = forward_encoders(P, cfg, batch, prec)
    # the render's inputs as leaves, [query; view]
    lv = {k: v.detach().requires_grad_(v.requires_grad) for k, v in dict(
        pose=torch.cat([enc["pose"], enc["pose_nn"]]),
        intr=torch.cat([enc["intr"], enc["intr_nn"]]),
        scale=torch.cat([enc["est"].scale_dist, enc["est_nn"].scale_dist]),
        lat_sdf=torch.cat([enc["lat_sdf"]] * 2),
        lat_rgb=torch.cat([enc["lat_rgb"], enc["lat_rgb_nn"]])).items()}
    inputs = dict(lv, ray_idx=torch.cat([batch["ray_idx"],
                                         batch["ray_idx_NN"][:, 0]]),
                  t_rand=draws["t_rand"])
    blocks = [slice(i, min(i + block, 2 * B)) for i in range(0, 2 * B, block)]
    with torch.no_grad():
        parts = [_render_group(P, cfg, inputs, r, prec) for r in blocks]
    outs = M.Render(*(torch.cat(p).requires_grad_() for p in zip(*parts)))
    q = slice(0, B)
    n = slice(B, 2 * B)
    eik = eikonal_norms(P, cfg, lv["pose"][q], lv["intr"][q], lv["scale"][q],
                        lv["lat_sdf"][q], inputs["ray_idx"][q],
                        inputs["t_rand"][q], draws["eik_idx"][q],
                        draws["eik_uniform"], prec)
    terms, total = losses(cfg, batch, enc, M.Render(*(o[q] for o in outs)),
                          M.Render(*(o[n] for o in outs)), eik)
    total.backward(retain_graph=True)   # the encoders' graph is used again
    for r in blocks:
        with torch.enable_grad():
            part = _render_group(P, cfg, inputs, r, prec)
        cots = [None if o.grad is None else o.grad[r] for o in outs]
        pairs = [(t, c) for t, c in zip(part, cots) if c is not None]
        torch.autograd.backward([t for t, _ in pairs], [c for _, c in pairs])
    roots = dict(pose=(enc["pose"], enc["pose_nn"]),
                 intr=(enc["intr"], enc["intr_nn"]),
                 scale=(enc["est"].scale_dist, enc["est_nn"].scale_dist),
                 lat_rgb=(enc["lat_rgb"], enc["lat_rgb_nn"]))
    tensors, grads = [], []
    for k, (a, b) in roots.items():
        g = lv[k].grad
        if g is not None and a.requires_grad:
            tensors += [a, b]
            grads += [g[q], g[n]]
    g = lv["lat_sdf"].grad
    if g is not None:
        tensors.append(enc["lat_sdf"])
        grads.append(g[q] + g[n])
    torch.autograd.backward(tensors, grads)
    return ({k: float(v.detach()) for k, v in terms.items()},
            float(total.detach()))


class Adam:
    """torch.optim.Adam's update: lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
            p.grad = None


def train_steps(weights, buffers, cfg, batches, draws, prec, block=4):
    """Full steps from `weights` over `batches` with `draws` -> per step
    its loss, the first step's gradient of each parameter, and each
    parameter's change over all the steps."""
    P = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    P.update(buffers)
    params = {k: P[k] for k in weights}
    optim_cfg = cfg["optim"]
    extra = optim_cfg.get("params") or {}
    adam = Adam(params, float(optim_cfg["lr"]),
                tuple(extra.get("betas", (0.9, 0.999))),
                float(extra.get("eps", 1e-8)))
    out = dict(loss=[], terms=[])
    for i, (batch, d) in enumerate(zip(batches, draws)):
        terms, total = loss_and_grads(P, cfg, batch, d, prec, block)
        out["loss"].append(total)
        out["terms"].append(terms)
        if i == 0:
            out["grad"] = {k: (p.grad.detach().clone() if p.grad is not None
                               else torch.zeros_like(p))
                           for k, p in params.items()}
        adam.step()
    out["change"] = {k: (p.detach() - weights[k]) for k, p in params.items()}
    return out


@torch.no_grad()
def request(P, cfg, image, view_poses, prec):
    """One request on image [1, H, W, 3]: -> dict of the latents, pose,
    eval-render maps, SDF grid and the turntable renders at `view_poses`
    [V, 3, 4]."""
    H, W = cfg["image_size"]
    He, We = cfg["eval"]["image_size"]
    lat_sdf, lat_rgb = M.encode(P, cfg, image, False, prec)
    est = M.estimator(P, cfg, image, False, prec)
    pose, intr = M.pose_and_intr(cfg, est, He, We)
    out = M.render(P, cfg, pose, intr, est.scale_dist, lat_sdf, lat_rgb, He,
                   We, prec)
    level = M.sdf_grid(P, cfg, lat_sdf, prec)
    views = []
    for v in range(view_poses.shape[0]):
        r = M.render(P, cfg, view_poses[v:v + 1], intr,
                     torch.ones_like(est.scale_dist), lat_sdf, lat_rgb, He,
                     We, prec)
        views.append(r)
    return dict(lat_sdf=lat_sdf, lat_rgb=lat_rgb, pose=pose, render=out,
                level=level, views=views)
