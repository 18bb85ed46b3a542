"""CamCalib bin-classification losses (torch twin of
``spec_tpu/losses/camcalib.py``).

Per-angle losses over the 256-logit bin heads: cross-entropy,
KL(one-hot) (equal to CE, the one-hot's entropy being 0), softargmax-L2
on the soft index, and the "biased L2" that penalizes over-predicting
the vfov harder (``where(pred > target, l2, l2 / (l2 + 1))``). Each takes
(B, 256) logits and targets and returns a scalar, in exact fp32.
"""

from __future__ import annotations

import torch

from spec_tpu_torch.core.bins import softargmax1d
from spec_tpu_torch.utils.precision import exact_fp32_fn


@exact_fp32_fn
def cross_entropy_loss(logits, target_bins):
    """Mean CE with integer bin targets (``nn.CrossEntropyLoss``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, target_bins[:, None].long())[:, 0]
    return -picked.mean()


def kl_one_hot_loss(logits, target_bins):
    """KL(one-hot || softmax(logits)), batchmean: equal to CE."""
    return cross_entropy_loss(logits, target_bins)


@exact_fp32_fn
def softargmax_l2_loss(logits, target_soft_idx):
    """L2 between the softargmax of the logits and the soft index."""
    pred = softargmax1d(logits)
    return ((target_soft_idx.float() - pred) ** 2).mean()


@exact_fp32_fn
def softargmax_biased_l2_loss(logits, target_soft_idx):
    """Biased L2: quadratic when over-predicting, ``l2 / (l2 + 1)``
    when under-predicting (the vfov's loss)."""
    pred = softargmax1d(logits)
    t = target_soft_idx.float()
    l2 = (t - pred) ** 2
    return torch.where(pred > t, l2, l2 / (l2 + 1.0)).mean()


def camera_regressor_loss(pred_vfov, pred_pitch, pred_roll, gt_vfov,
                          gt_pitch, gt_roll,
                          loss_type: str = 'softargmax_biased_l2',
                          vfov_loss_weight: float = 1.0,
                          pitch_loss_weight: float = 1.0,
                          roll_loss_weight: float = 1.0):
    """The three heads' weighted losses (reference
    ``CameraRegressorLoss``). Targets are bin indices for 'ce'/'kl' and
    soft indices in [-1, 1] for the softargmax losses. Returns (total,
    dict of per-angle terms)."""
    if loss_type in ('ce', 'kl'):
        fn = vfov_fn = cross_entropy_loss
    elif loss_type == 'softargmax_l2':
        fn = vfov_fn = softargmax_l2_loss
    elif loss_type == 'softargmax_biased_l2':
        fn, vfov_fn = softargmax_l2_loss, softargmax_biased_l2_loss
    else:
        raise ValueError(f'unknown loss_type: {loss_type}')
    vfov_loss = vfov_loss_weight * vfov_fn(pred_vfov, gt_vfov)
    pitch_loss = pitch_loss_weight * fn(pred_pitch, gt_pitch)
    roll_loss = roll_loss_weight * fn(pred_roll, gt_roll)
    total = vfov_loss + pitch_loss + roll_loss
    return total, {'loss': total, 'vfov_loss': vfov_loss,
                   'pitch_loss': pitch_loss, 'roll_loss': roll_loss}
