"""SMPL projection heads (torch twin of
``spec_tpu/models/heads/smpl_head.py``).

Output keys: ``smpl_vertices`` (B, V, 3), ``smpl_joints3d`` (B, 49, 3),
``smpl_joints2d`` (B, 49, 2), ``pred_cam_t`` (B, 3).
"""

from __future__ import annotations

import torch

from spec_tpu_torch.core import geometry as G
from spec_tpu_torch.core.smpl import SMPLAssets, smpl_forward


def _smpl49(assets: SMPLAssets, rotmat: torch.Tensor, shape: torch.Tensor):
    return smpl_forward(assets, betas=shape, body_pose=rotmat[:, 1:],
                        global_orient=rotmat[:, 0:1], pose2rot=False,
                        joint_set='spin49')


def smpl_cam_head(
    assets: SMPLAssets,
    rotmat: torch.Tensor,
    shape: torch.Tensor,
    cam: torch.Tensor,
    cam_rotmat: torch.Tensor,
    cam_intrinsics: torch.Tensor,
    bbox_scale: torch.Tensor,
    bbox_center: torch.Tensor,
    img_w: torch.Tensor,
    img_h: torch.Tensor,
    crop_res: int = 224,
    normalize_joints2d: bool = False,
) -> dict:
    """Camera-conditioned SMPL head (the SPEC path): lift the crop
    weak-perspective camera into the full image and project the joints
    with the estimated camera.

    rotmat (B, 24, 3, 3); shape (B, 10); cam (B, 3) (s, tx, ty);
    cam_rotmat, cam_intrinsics (B, 3, 3); bbox_scale (B,);
    bbox_center (B, 2); img_w, img_h (B,).
    """
    out = _smpl49(assets, rotmat, shape)
    cam_t = G.weak_perspective_to_full_translation(
        cam, bbox_center, bbox_scale, img_w, img_h, cam_intrinsics[:, 0, 0],
        crop_res=crop_res)
    joints2d = G.perspective_projection(
        out.joints, rotation=cam_rotmat, translation=cam_t,
        cam_intrinsics=cam_intrinsics)
    if normalize_joints2d:
        joints2d = joints2d / (crop_res / 2.0)
    return {'smpl_vertices': out.vertices, 'smpl_joints3d': out.joints,
            'smpl_joints2d': joints2d, 'pred_cam_t': cam_t}


def smpl_head(
    assets: SMPLAssets,
    rotmat: torch.Tensor,
    shape: torch.Tensor,
    cam: torch.Tensor,
    focal_length: float = 5000.0,
    img_res: int = 224,
    normalize_joints2d: bool = True,
) -> dict:
    """Crop-frame SMPL head (the non-cam HMR path): weak-perspective
    placement at a fixed focal length, joints2d in [-1, 1]."""
    out = _smpl49(assets, rotmat, shape)
    joints2d = G.weak_perspective_projection(
        out.joints, cam, focal_length=focal_length, img_res=img_res)
    if not normalize_joints2d:
        joints2d = (joints2d + 1.0) * (img_res / 2.0)
    cam_t = G.weak_perspective_cam_t(cam, focal_length, img_res)
    return {'smpl_vertices': out.vertices, 'smpl_joints3d': out.joints,
            'smpl_joints2d': joints2d, 'pred_cam_t': cam_t}
