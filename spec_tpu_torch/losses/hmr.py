"""HMR / HMR-Cam training losses (torch twin of
``spec_tpu/losses/hmr.py``).

Every mask is a multiplicative weight with a safe normalizer, so each
loss has static shapes and can sit inside a captured CUDA graph (the
reference masks by boolean indexing). The losses run in exact fp32
(``utils/precision.exact_fp32``), outside any autocast region.

Reference quirks kept, so the values match:

* the pose term reduces the rotation MSE to a scalar BEFORE weighting by
  the per-joint confidence: ``mse(valid) * mean(conf(valid))``;
* the 3D keypoint loss uses joints 25+ of the 49-joint set, the pelvis is
  the midpoint of GT-set joints 2 and 3 (the hips), and confidences come
  from the GT's 4th column;
* the camera regularizer is ``mean(exp(-10 s)^2)``, with ``s`` clamped
  at -4 (:func:`_cam_regularizer`);
* the cam variant's 2D loss uses FULL-IMAGE keypoints normalized to
  [-1, 1] by (W, H), rescaled per sample by ``img_size / (bbox_scale *
  200)`` to crop-loss magnitude.

In a data-parallel train step (``parallel.sharded_batch``) each loss is
this rank's share of the loss over the global batch: the masked means
divide by the global counts (``parallel.all_reduce_data``) and the
plain means by the global row count (``parallel.batch_mean``), as the
JAX mesh step computes them over its sharded batch. A mean of per-rank
means would differ whenever the ranks hold different numbers of
``has_smpl`` or ``has_pose_3d`` rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from spec_tpu_torch import parallel as par
from spec_tpu_torch.core.geometry import rodrigues, rotmat_to_rot6d
from spec_tpu_torch.utils.precision import exact_fp32_fn


def _safe_div(num, den):
    return num / torch.clamp(den, min=1.0)


def _masked_row_mean(per_elem: torch.Tensor, row_mask: torch.Tensor):
    """Mean over the elements of the rows ``row_mask`` selects: torch's
    ``tensor[mask].mean()`` with static shapes (0 when none is); over
    the global batch in a sharded one."""
    mask = row_mask.to(per_elem.dtype).reshape(
        (-1,) + (1,) * (per_elem.ndim - 1))
    numel_per_row = float(math.prod(per_elem.shape[1:]))
    return _safe_div((per_elem * mask).sum(), par.all_reduce_data(
        row_mask.to(per_elem.dtype).sum() * numel_per_row))


@exact_fp32_fn
def smpl_param_loss(pred_rotmat, pred_betas, gt_pose_aa, gt_betas, has_smpl,
                    pose_conf):
    """Pose and shape parameter losses (reference ``smpl_losses``):
    pred_rotmat (B, 24, 3, 3), pred_betas (B, 10), gt_pose_aa (B, 72),
    gt_betas (B, 10), has_smpl (B,), pose_conf (B, 24)."""
    B = pred_rotmat.shape[0]
    gt_rotmat = rodrigues(gt_pose_aa.reshape(B, 24, 3))
    valid = has_smpl.float()
    mse_pose = _masked_row_mean((pred_rotmat - gt_rotmat) ** 2, valid)
    mean_conf = _safe_div(
        par.all_reduce_data((pose_conf.mean(dim=1) * valid).sum()),
        par.all_reduce_data(valid.sum()))
    loss_pose = mse_pose * mean_conf
    loss_betas = _masked_row_mean((pred_betas - gt_betas) ** 2, valid)
    return loss_pose, loss_betas


@exact_fp32_fn
def keypoint_3d_loss(pred_joints, gt_joints, has_pose_3d):
    """Pelvis-centred 3D keypoint loss on the 24 GT-set joints:
    pred_joints (B, 49, 3), gt_joints (B, 24, 4) xyz + conf."""
    pred = pred_joints[:, 25:, :]
    conf = gt_joints[..., 3:4]
    gt = gt_joints[..., :3]
    gt_pelvis = (gt[:, 2:3] + gt[:, 3:4]) / 2.0
    pred_pelvis = (pred[:, 2:3] + pred[:, 3:4]) / 2.0
    per_elem = conf * (pred - pred_pelvis - (gt - gt_pelvis)) ** 2
    return _masked_row_mean(per_elem, has_pose_3d.float())


@exact_fp32_fn
def shape_loss(pred_vertices, gt_vertices, has_smpl):
    """L1 vertex loss over the samples with SMPL GT."""
    return _masked_row_mean((pred_vertices - gt_vertices).abs(),
                            has_smpl.float())


@exact_fp32_fn
def projected_keypoint_loss(pred_kp2d, gt_kp2d, openpose_weight: float,
                            gt_weight: float):
    """Confidence-weighted 2D MSE, unreduced (B, 49, 2): the first 25
    joints weigh ``openpose_weight``, the other 24 ``gt_weight``."""
    conf = gt_kp2d[..., 2:3]
    w = torch.cat([
        torch.full((25, 1), float(openpose_weight), dtype=torch.float32,
                   device=pred_kp2d.device),
        torch.full((24, 1), float(gt_weight), dtype=torch.float32,
                   device=pred_kp2d.device)])[None]
    return conf * w * (pred_kp2d - gt_kp2d[..., :2]) ** 2


@exact_fp32_fn
def gaussian_nll(pred_mean, pred_logvar, target):
    """Heteroscedastic Gaussian NLL ``0.5 (exp(-s) err^2 + s)``, mean."""
    err2 = (pred_mean - target) ** 2
    return par.batch_mean(0.5 * (torch.exp(-pred_logvar) * err2
                                 + pred_logvar))


@exact_fp32_fn
def smpl_param_loss_uncertainty(pred_pose6d, pred_pose6d_logvar, pred_betas,
                                pred_betas_logvar, gt_pose_aa, gt_betas,
                                has_smpl):
    """Uncertainty-weighted parameter loss: the GT pose goes aa -> rotmat
    -> rot6d and is compared in 6D; the NLL replaces the plain MSE."""
    B = pred_pose6d.shape[0]
    gt_rot6d = rotmat_to_rot6d(
        rodrigues(gt_pose_aa.reshape(B, 24, 3))).reshape(B, 144)
    valid = has_smpl.float()
    nll_pose = 0.5 * (torch.exp(-pred_pose6d_logvar)
                      * (pred_pose6d - gt_rot6d) ** 2 + pred_pose6d_logvar)
    nll_betas = 0.5 * (torch.exp(-pred_betas_logvar)
                       * (pred_betas - gt_betas) ** 2 + pred_betas_logvar)
    return (_masked_row_mean(nll_pose, valid),
            _masked_row_mean(nll_betas, valid))


@dataclasses.dataclass(frozen=True)
class HMRLossConfig:
    """Loss weights (the reference's HMR.*_LOSS_WEIGHT defaults)."""

    shape_loss_weight: float = 0.0
    keypoint_loss_weight: float = 5.0
    pose_loss_weight: float = 1.0
    beta_loss_weight: float = 0.001
    openpose_train_weight: float = 0.0
    gt_train_weight: float = 1.0
    loss_weight: float = 60.0


def _cam_regularizer(pred_cam):
    """``mean(exp(-10 s)^2)`` with ``s`` clamped at -4 so fp32 stays
    finite: below that the reference's value overflows and training has
    already diverged; exact for every s > -4."""
    s = torch.clamp(pred_cam[:, 0], min=-4.0)
    return par.batch_mean(torch.exp(-s * 10.0) ** 2)


def _weighted(cfg, loss_keypoints, loss_keypoints_3d, loss_pose, loss_betas,
              loss_shape, loss_cam):
    loss_dict = {
        'loss/loss_keypoints': loss_keypoints * cfg.keypoint_loss_weight,
        'loss/loss_keypoints_3d':
            loss_keypoints_3d * cfg.keypoint_loss_weight,
        'loss/loss_regr_pose': loss_pose * cfg.pose_loss_weight,
        'loss/loss_regr_betas': loss_betas * cfg.beta_loss_weight,
        'loss/loss_shape': loss_shape * cfg.shape_loss_weight,
        'loss/loss_cam': loss_cam,
    }
    total = sum(loss_dict.values()) * cfg.loss_weight
    loss_dict['loss/total_loss'] = total
    return total, loss_dict


@exact_fp32_fn
def hmr_cam_loss(pred: dict, gt: dict, cfg: HMRLossConfig = HMRLossConfig()):
    """The SPEC training loss (reference ``HMRCamLoss.forward``).

    pred: pred_cam, pred_shape, pred_pose (rotmats), smpl_joints3d,
    smpl_vertices, smpl_joints2d (full-image pixels). gt: pose (B, 72
    aa), pose_conf (B, 24), betas, pose_3d (B, 24, 4), vertices,
    keypoints_orig (B, 49, 3 full-image pixels + conf), has_smpl,
    has_pose_3d, orig_shape (B, 2 as (H, W)), scale (B,) bbox scale.
    Returns (total, dict of weighted terms and the total)."""
    img_wh = gt['orig_shape'].flip(-1).float()               # (B, 2) = (W, H)
    wh = img_wh[:, None, :]
    pred_kp2d = 2.0 * pred['smpl_joints2d'][..., :2] / wh - 1.0
    gt_kp = gt['keypoints_orig']
    gt_kp2d = torch.cat([2.0 * gt_kp[..., :2] / wh - 1.0, gt_kp[..., 2:]],
                        dim=-1)

    loss_pose, loss_betas = smpl_param_loss(
        pred['pred_pose'], pred['pred_shape'], gt['pose'], gt['betas'],
        gt['has_smpl'], gt['pose_conf'])
    kp_loss = projected_keypoint_loss(
        pred_kp2d, gt_kp2d, cfg.openpose_train_weight, cfg.gt_train_weight)
    # To crop-loss magnitude: image size over bbox size.
    scale = img_wh / (gt['scale'][:, None].float() * 200.0)
    loss_keypoints = par.batch_mean(kp_loss * scale[:, None, :])
    loss_keypoints_3d = keypoint_3d_loss(
        pred['smpl_joints3d'], gt['pose_3d'], gt['has_pose_3d'])
    loss_shape = shape_loss(pred['smpl_vertices'], gt['vertices'],
                            gt['has_smpl'])
    return _weighted(cfg, loss_keypoints, loss_keypoints_3d, loss_pose,
                     loss_betas, loss_shape, _cam_regularizer(
                         pred['pred_cam']))


@exact_fp32_fn
def hmr_loss(pred: dict, gt: dict, cfg: HMRLossConfig = HMRLossConfig()):
    """Crop-frame HMR loss (reference ``HMRLoss.forward``): the 2D term
    uses the crop's normalized ``gt['keypoints']``, no bbox rescale."""
    loss_pose, loss_betas = smpl_param_loss(
        pred['pred_pose'], pred['pred_shape'], gt['pose'], gt['betas'],
        gt['has_smpl'], gt['pose_conf'])
    loss_keypoints = par.batch_mean(projected_keypoint_loss(
        pred['smpl_joints2d'], gt['keypoints'], cfg.openpose_train_weight,
        cfg.gt_train_weight))
    loss_keypoints_3d = keypoint_3d_loss(
        pred['smpl_joints3d'], gt['pose_3d'], gt['has_pose_3d'])
    loss_shape = shape_loss(pred['smpl_vertices'], gt['vertices'],
                            gt['has_smpl'])
    return _weighted(cfg, loss_keypoints, loss_keypoints_3d, loss_pose,
                     loss_betas, loss_shape, _cam_regularizer(
                         pred['pred_cam']))
