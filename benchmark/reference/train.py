"""SPEC's training step in plain PyTorch: the regressor in train mode
(BatchNorm on batch statistics, dropout 0.5 after both hidden layers),
the ground-truth mesh, SPEC's camera loss (``HMRCamLoss`` of
mkocabas/SPEC with the published weights), autograd through plain SMPL,
and Adam (optax's rule: bias-corrected moments, eps outside the root).
Float32; the caller sets TF32."""

from __future__ import annotations

import torch

from benchmark.reference import geometry as G
from benchmark.reference.smpl import cam_head, lbs

# HMR.*_LOSS_WEIGHT of SPEC's training config.
KEYPOINT, POSE, BETA, SHAPE, LOSS = 5.0, 1.0, 0.001, 0.0, 60.0
OPENPOSE_2D, GT_2D = 0.0, 1.0
B1, B2, EPS = 0.9, 0.999, 1e-8
DROPOUT = 0.5


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> (..., 3, 3); the first-order form below an
    angle of 1e-4."""
    sq = (aa * aa).sum(-1, keepdim=True)
    small = sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    x, y, z = (aa / theta).unbind(-1)
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        *aa.shape[:-1], 3, 3)
    t = theta[..., None]
    eye = torch.eye(3, device=aa.device).expand(K.shape)
    return torch.where(small[..., None], eye + K,
                       eye + t.sin() * K + (1 - t.cos()) * (K @ K))


def dropout(x: torch.Tensor, generator) -> torch.Tensor:
    """Inverted dropout: a uniform draw per element below the keep rate
    keeps it, scaled by 1 / keep."""
    keep = 1.0 - DROPOUT
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def masked_mean(per_elem, rows):
    """Mean over the elements of the selected rows (0 when none is)."""
    m = rows.reshape((-1,) + (1,) * (per_elem.ndim - 1))
    n = rows.sum() * per_elem[0].numel()
    return (per_elem * m).sum() / n.clamp_min(1.0)


def spec_loss(pred: dict, batch: dict, gt_verts) -> dict:
    """SPEC's camera loss: full-frame 2D keypoints normalized by the frame
    and brought to crop scale, pelvis-centred 3D joints, SMPL pose and
    shape, the vertices (weight 0) and the crop camera's scale prior."""
    B = pred['pred_pose'].shape[0]
    wh = batch['orig_shape'].flip(-1)[:, None, :]
    kp = batch['keypoints_orig']
    pred2d = 2.0 * pred['smpl_joints2d'] / wh - 1.0
    gt2d = 2.0 * kp[..., :2] / wh - 1.0
    w = torch.tensor([OPENPOSE_2D] * 25 + [GT_2D] * 24,
                     device=kp.device)[None, :, None]
    size = batch['orig_shape'].flip(-1) / (batch['scale'][:, None] * 200.0)
    l_kp = (kp[..., 2:] * w * (pred2d - gt2d) ** 2
            * size[:, None, :]).mean()
    j = pred['smpl_joints3d'][:, 25:]
    g = batch['pose_3d']
    jc = j - (j[:, 2:3] + j[:, 3:4]) / 2
    gc = g[..., :3] - (g[:, 2:3, :3] + g[:, 3:4, :3]) / 2
    l_kp3d = masked_mean(g[..., 3:] * (jc - gc) ** 2, batch['has_pose_3d'])
    smpl = batch['has_smpl']
    gt_rot = rodrigues(batch['pose'].reshape(B, 24, 3))
    conf = (batch['pose_conf'].mean(1) * smpl).sum() / smpl.sum().clamp_min(
        1.0)
    l_pose = masked_mean((pred['pred_pose'] - gt_rot) ** 2, smpl) * conf
    l_betas = masked_mean((pred['pred_shape'] - batch['betas']) ** 2, smpl)
    l_shape = masked_mean((pred['smpl_vertices'] - gt_verts).abs(), smpl)
    s = pred['pred_cam'][:, 0].clamp(min=-4.0)
    l_cam = (torch.exp(-10.0 * s) ** 2).mean()
    total = (KEYPOINT * (l_kp + l_kp3d) + POSE * l_pose + BETA * l_betas
             + SHAPE * l_shape + l_cam) * LOSS
    return total


def forward(hmr, assets, batch, generator):
    """The regressor in train mode and SPEC's SMPL head on the batch's
    ground-truth camera."""
    x = batch['img'].permute(0, 3, 1, 2)
    feats = hmr.backbone(x).mean(dim=(2, 3))
    head = hmr.head
    B = feats.shape[0]
    pose = head.init_pose.expand(B, -1)
    shape = head.init_shape.expand(B, -1)
    cam = head.init_cam.expand(B, -1)
    for _ in range(head.n_iter):
        h = dropout(head.fc1(torch.cat([feats, pose, shape, cam], 1)),
                    generator)
        h = dropout(head.fc2(h), generator)
        pose = head.decpose(h) + pose
        shape = head.decshape(h) + shape
        cam = head.deccam(h) + cam
    out = {'pred_pose': G.rot6d_to_rotmat(pose.reshape(B, 24, 6)),
           'pred_shape': shape, 'pred_cam': cam}
    K = batch['cam_intrinsics']
    out.update(cam_head(assets, out, batch['cam_rotmat'], K[:, 0, 0],
                        batch['center'], batch['scale'],
                        batch['orig_shape'][:, 1], batch['orig_shape'][:, 0],
                        batch['img'].shape[1]))
    return out


def gt_vertices(assets, batch):
    with torch.no_grad():
        B = batch['pose'].shape[0]
        return lbs(assets, batch['betas'],
                   rodrigues(batch['pose'].reshape(B, 24, 3)))[0]


class Adam:
    """optax.adam over named tensors."""

    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(B1).add_(g, alpha=1 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            mh = self.m[k] / (1 - B1 ** self.t)
            vh = self.v[k] / (1 - B2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + EPS))


def trainable(hmr) -> dict:
    """The regressor's parameters and its mean-parameter buffers, which
    SPEC trains, by name."""
    named = dict(hmr.named_parameters())
    for name, buf in hmr.named_buffers():
        if name.rsplit('.', 1)[-1] in ('init_pose', 'init_shape',
                                       'init_cam'):
            named[name] = buf.requires_grad_(True)
    return named


def steps(hmr, assets, batches, generator, lr: float) -> dict:
    """Train ``hmr`` in place on ``batches`` in turn. Returns each step's
    loss, the first step's gradient per tensor, and each tensor's change
    over all the steps."""
    hmr.train()
    params = trainable(hmr)
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for batch in batches:
        gt = gt_vertices(assets, batch)
        loss = spec_loss(forward(hmr, assets, batch, generator), batch, gt)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return {'losses': losses, 'grads': first,
            'change': {k: (params[k].detach() - start[k]) for k in params}}
