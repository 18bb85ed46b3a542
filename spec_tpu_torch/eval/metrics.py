"""Evaluation metrics, batched on the device (torch twin of
``spec_tpu/eval/metrics.py``).

The reference's metric math: MPJPE, PA-MPJPE (a batched 3x3 SVD
Procrustes, :func:`~spec_tpu_torch.core.geometry.procrustes_align`),
V2V, the 14/17-joint H36M-regressor protocol and the 24-native-joint
protocol. Every matmul and einsum runs in exact fp32 with autocast off
(:func:`~spec_tpu_torch.utils.precision.exact_fp32`): the eval step's
model may run under bf16 autocast, and these must not.

Distances are in the input unit (meters for SMPL); callers scale by 1000
for mm.
"""

from __future__ import annotations

import torch

from spec_tpu_torch.core import constants as C
from spec_tpu_torch.core.geometry import procrustes_align
from spec_tpu_torch.utils.graphs import device_constant
from spec_tpu_torch.utils.precision import exact_fp32_fn


def per_joint_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Euclidean distance per joint: (B, J, 3) x2 -> (B, J)."""
    return torch.sqrt(((pred.float() - gt.float()) ** 2).sum(-1))


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error, per sample: -> (B,)."""
    return per_joint_error(pred, gt).mean(-1)


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor):
    """Procrustes-aligned MPJPE: (per sample (B,), per joint (B, J))."""
    pj = per_joint_error(procrustes_align(pred, gt), gt)
    return pj.mean(-1), pj


def v2v_error(pred_verts: torch.Tensor,
              gt_verts: torch.Tensor) -> torch.Tensor:
    """Per-vertex error, per sample: -> (B,)."""
    return per_joint_error(pred_verts, gt_verts).mean(-1)


@exact_fp32_fn
def regress_h36m(vertices: torch.Tensor,
                 j_regressor_h36m: torch.Tensor) -> torch.Tensor:
    """(B, V, 3), (17, V) -> (B, 17, 3)."""
    return torch.einsum('jv,bvc->bjc', j_regressor_h36m.float(),
                        vertices.float())


def eval_mesh_j14_head(pred_vertices: torch.Tensor,
                       gt_vertices: torch.Tensor,
                       j_regressor_h36m: torch.Tensor,
                       subset: str = 'j14') -> dict:
    """The 14-joint (or 17, ``subset='j17'``) H36M-regressor protocol up
    to Procrustes: joints from each mesh, pelvis = H36M joint 0,
    pelvis-centred V2V.

    Returns per sample: mpjpe, v2v (B,), per_joint_mpjpe (B, 14 or 17),
    and the centred joint sets that PA-MPJPE aligns, pa_pred and pa_gt
    (B, 14 or 17, 3); :func:`pa_tail` finishes it."""
    sel = device_constant(C.H36M_TO_J17 if subset == 'j17'
                          else C.H36M_TO_J14, pred_vertices.device,
                          torch.long)
    pj = regress_h36m(pred_vertices, j_regressor_h36m)
    gj = regress_h36m(gt_vertices, j_regressor_h36m)
    p_pelvis, g_pelvis = pj[:, 0:1], gj[:, 0:1]
    pj = pj[:, sel] - p_pelvis
    gj = gj[:, sel] - g_pelvis
    err = per_joint_error(pj, gj)
    v2v = v2v_error(pred_vertices.float() - p_pelvis,
                    gt_vertices.float() - g_pelvis)
    return {'mpjpe': err.mean(-1), 'v2v': v2v, 'per_joint_mpjpe': err,
            'pa_pred': pj, 'pa_gt': gj}


def eval_joints_24_head(pred_joints24: torch.Tensor,
                        gt_joints24: torch.Tensor) -> dict:
    """The 24-native-SMPL-joint protocol up to Procrustes: pelvis = joint
    0 of each set. Returns mpjpe (B,), per_joint_mpjpe (B, 24), pa_pred
    and pa_gt (B, 24, 3); :func:`pa_tail` finishes it."""
    pj = pred_joints24.float() - pred_joints24[:, 0:1].float()
    gj = gt_joints24.float() - gt_joints24[:, 0:1].float()
    err = per_joint_error(pj, gj)
    return {'mpjpe': err.mean(-1), 'per_joint_mpjpe': err,
            'pa_pred': pj, 'pa_gt': gj}


def pa_tail(head: dict) -> dict:
    """A protocol's head finished: pa_pred and pa_gt replaced by
    pa_mpjpe (B,) and per_joint_pa (B, J). Its batched SVD copies to the
    host on CUDA, so a CUDA graph cannot capture it: the eval step and
    the offline chunk capture the head and run this eagerly."""
    out = {k: v for k, v in head.items() if k not in ('pa_pred', 'pa_gt')}
    out['pa_mpjpe'], out['per_joint_pa'] = pa_mpjpe(head['pa_pred'],
                                                    head['pa_gt'])
    return out


def eval_mesh_j14(pred_vertices: torch.Tensor, gt_vertices: torch.Tensor,
                  j_regressor_h36m: torch.Tensor,
                  subset: str = 'j14') -> dict:
    """The whole 14- (or 17-) joint protocol: mpjpe, pa_mpjpe, v2v (B,),
    per_joint_mpjpe and per_joint_pa (B, 14 or 17)."""
    return pa_tail(eval_mesh_j14_head(pred_vertices, gt_vertices,
                                      j_regressor_h36m, subset))


def eval_joints_24(pred_joints24: torch.Tensor,
                   gt_joints24: torch.Tensor) -> dict:
    """The whole 24-joint protocol: mpjpe, pa_mpjpe (B,),
    per_joint_mpjpe, per_joint_pa (B, 24)."""
    return pa_tail(eval_joints_24_head(pred_joints24, gt_joints24))


@exact_fp32_fn
def rotate_points(rotmat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3), (B, N, 3) -> (B, N, 3): the world-to-camera rotation of
    the camera-frame metrics."""
    return torch.einsum('bij,bnj->bni', rotmat.float(), points.float())
