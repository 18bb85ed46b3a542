"""Dense-supervision losses for PARE-style heads (torch twin of
``spec_tpu/losses/aux.py``): keypoint-heatmap MSE and per-pixel
part-segmentation cross-entropy, both with static-shape masks; in a
data-parallel train step each is this rank's share of the global
batch's loss (``parallel.sharded_batch``)."""

from __future__ import annotations

from typing import Optional

import torch

from spec_tpu_torch import parallel as par
from spec_tpu_torch.utils.precision import exact_fp32_fn


@exact_fp32_fn
def joints_mse_loss(pred_heatmaps, gt_heatmaps,
                    target_weight: Optional[torch.Tensor] = None):
    """Heatmap MSE weighted per joint (``JointsMSELoss``): per joint
    ``0.5 * mse(pred * w, gt * w)`` over batch and pixels, averaged over
    joints. Heatmaps (B, J, H, W); target_weight (B, J) or (B, J, 1)."""
    B, J = pred_heatmaps.shape[:2]
    pred = pred_heatmaps.reshape(B, J, -1).float()
    gt = gt_heatmaps.reshape(B, J, -1).float()
    if target_weight is not None:
        w = target_weight.reshape(B, J, 1).float()
        pred = pred * w
        gt = gt * w
    if par.batch_world() == 1:
        return (0.5 * ((pred - gt) ** 2).mean(dim=(0, 2))).mean()
    per_joint = ((pred - gt) ** 2).sum(dim=(0, 2)) / (
        B * par.batch_world() * pred.shape[2])
    return (0.5 * per_joint).mean()


@exact_fp32_fn
def pixelwise_cross_entropy(logits, target, ignore_index: int = -1,
                            class_weights: Optional[torch.Tensor] = None):
    """Per-pixel softmax CE over (B, C, H, W) scores and a (B, H, W)
    class map: the weighted mean NLL of the target class, skipping
    ``ignore_index`` pixels (``nn.CrossEntropyLoss`` semantics)."""
    B, C = logits.shape[:2]
    logp = torch.log_softmax(logits.float().reshape(B, C, -1), dim=1)
    tgt = target.reshape(B, -1).long()
    valid = tgt != ignore_index
    safe = torch.where(valid, tgt, torch.zeros_like(tgt))
    nll = -torch.gather(logp, 1, safe[:, None, :])[:, 0]       # (B, P)
    w = valid.float()
    if class_weights is not None:
        w = w * class_weights.float()[safe]
    return (nll * w).sum() / torch.clamp(par.all_reduce_data(w.sum()),
                                         min=1e-12)
