"""SPEC's camera-conditioned HMR model (torch twin of
``spec_tpu/models/hmr.py``): backbone -> HMRHead (optionally conditioned
on the CamCalib camera) -> SMPL(Cam) projection head. SMPL tensors come
in as an argument, as in the JAX module. ``backbone``: a ResNet or
HRNet (``hrnet_w32-conv`` ...; ``models/backbones``). ``remat``
(TRAINING.REMAT) checkpoints each ResNet block or HRNet exchange module:
a memory knob, numerically the same."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from spec_tpu_torch.core.smpl import SMPLAssets
from spec_tpu_torch.models.backbones import get_backbone
from spec_tpu_torch.models.heads.hmr_head import HMRHead
from spec_tpu_torch.models.heads.smpl_head import smpl_cam_head, smpl_head
from spec_tpu_torch.utils.precision import compute_dtype


class HMR(nn.Module):
    """Composite SPEC network; ``dtype`` is the backbone and head FC
    compute dtype (float32 or bfloat16). Parameter names: ``backbone.*``
    (torchvision or official HRNet) and ``head.*`` (PARE/SPIN head)."""

    def __init__(self, backbone: str = 'resnet50', use_cam: bool = True,
                 use_cam_feats: bool = False, focal_length: float = 5000.0,
                 img_res: int = 224, dtype: torch.dtype = torch.float32,
                 mean_params: Optional[dict] = None,
                 remat: bool = False):
        super().__init__()
        self.use_cam = use_cam
        self.use_cam_feats = use_cam_feats
        self.focal_length = focal_length
        self.img_res = img_res
        self.dtype = dtype
        self.backbone = get_backbone(backbone, remat=remat)
        self.head = HMRHead(self.backbone.out_channels,
                            use_cam_feats=use_cam_feats, dtype=dtype,
                            mean_params=mean_params)

    def forward(
        self,
        smpl_assets: SMPLAssets,
        images: torch.Tensor,
        cam_rotmat: Optional[torch.Tensor] = None,
        cam_intrinsics: Optional[torch.Tensor] = None,
        bbox_scale: Optional[torch.Tensor] = None,
        bbox_center: Optional[torch.Tensor] = None,
        img_w: Optional[torch.Tensor] = None,
        img_h: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """images (B, res, res, 3) normalized NHWC person crops; the
        camera arguments are needed with ``use_cam`` or
        ``use_cam_feats``; ``generator`` draws the head's train-mode
        dropout masks. Returns pred_pose (B, 24, 3, 3), pred_pose_6d,
        pred_shape, pred_cam, smpl_vertices, smpl_joints3d,
        smpl_joints2d, pred_cam_t."""
        with compute_dtype(self.dtype, images.device.type):
            features = self.backbone(images.permute(0, 3, 1, 2))
        if self.use_cam_feats:
            # vfov from fx, as the reference conditions the head
            # (released checkpoints were trained on this input).
            cam_vfov = 2.0 * torch.atan(
                img_h.float() / (2.0 * cam_intrinsics[:, 0, 0]))
            hmr_out = self.head(features, cam_rotmat=cam_rotmat,
                                cam_vfov=cam_vfov, generator=generator)
        else:
            hmr_out = self.head(features, generator=generator)

        if self.use_cam:
            smpl_out = smpl_cam_head(
                smpl_assets, rotmat=hmr_out['pred_pose'],
                shape=hmr_out['pred_shape'], cam=hmr_out['pred_cam'],
                cam_rotmat=cam_rotmat, cam_intrinsics=cam_intrinsics,
                bbox_scale=bbox_scale, bbox_center=bbox_center,
                img_w=img_w, img_h=img_h, crop_res=self.img_res,
                normalize_joints2d=False)
        else:
            smpl_out = smpl_head(
                smpl_assets, rotmat=hmr_out['pred_pose'],
                shape=hmr_out['pred_shape'], cam=hmr_out['pred_cam'],
                focal_length=self.focal_length, img_res=self.img_res,
                normalize_joints2d=True)
        smpl_out.update(hmr_out)
        return smpl_out

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        self.head.reset_parameters(generator)
