"""SPEC's camera-conditioned HMR model (torch twin of
``spec_tpu/models/hmr.py``): backbone -> HMRHead (optionally conditioned
on the CamCalib camera) -> SMPL(Cam) projection head. SMPL tensors come
in as an argument, as in the JAX module. ``backbone``: a ResNet or
HRNet (``hrnet_w32-conv`` ...; ``models/backbones``), or HMR 2.0's
``vit_h``. ``head``: SPIN's iterative regressor (``hmr``) or HMR 2.0's
transformer decoder (``transformer_decoder``; no JAX counterpart). A
``vit_h`` trunk sees the central three quarters of the crop's columns
(256 x 192 of a 256² crop, HMR 2.0's ``x[:, :, :, 32:-32]``). ``remat``
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
from spec_tpu_torch.models.heads.transformer_head import (
    TransformerDecoderHead,
)
from spec_tpu_torch.utils.precision import compute_dtype


def default_img_res(backbone: str) -> int:
    """The crop side a trunk is run at where none is given: a ViT's input
    height (256 for ``vit_h``), SPEC's 224 for the others."""
    if backbone.startswith('vit'):
        from spec_tpu_torch.models.backbones.vit import VIT_SIZES

        return VIT_SIZES[backbone]['img_size'][0]
    return 224


class HMR(nn.Module):
    """Composite SPEC network; ``dtype`` is the backbone and head FC
    compute dtype (float32 or bfloat16). Parameter names: ``backbone.*``
    (torchvision, official HRNet or ViTPose) and ``head.*`` (PARE/SPIN
    head, or HMR 2.0's decoder)."""

    def __init__(self, backbone: str = 'resnet50', use_cam: bool = True,
                 use_cam_feats: bool = False, focal_length: float = 5000.0,
                 img_res: int = 224, dtype: torch.dtype = torch.float32,
                 mean_params: Optional[dict] = None,
                 remat: bool = False, head: str = 'hmr'):
        super().__init__()
        self.use_cam = use_cam
        self.use_cam_feats = use_cam_feats
        self.focal_length = focal_length
        self.img_res = img_res
        self.dtype = dtype
        self.backbone = get_backbone(backbone, remat=remat)
        # a ViT takes the central columns of the square crop
        self.cols = img_res // 8 if backbone.startswith('vit') else 0
        seen = (img_res, img_res - 2 * self.cols)
        if self.cols and self.backbone.img_size != seen:
            raise ValueError(f'{backbone} takes {self.backbone.img_size} '
                             f'crops, not the centre of {img_res}²')
        if head == 'hmr':
            self.head = HMRHead(self.backbone.out_channels,
                                use_cam_feats=use_cam_feats, dtype=dtype,
                                mean_params=mean_params)
        elif head == 'transformer_decoder':
            if use_cam_feats:
                raise ValueError('the transformer_decoder head takes no '
                                 'camera features (use_cam_feats)')
            self.head = TransformerDecoderHead(self.backbone.out_channels,
                                               dtype=dtype,
                                               mean_params=mean_params)
        else:
            raise ValueError(f'unknown head {head!r}; use hmr or '
                             'transformer_decoder')

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
        trunk=None,
    ) -> dict:
        """images (B, res, res, 3) normalized NHWC person crops; the
        camera arguments are needed with ``use_cam`` or
        ``use_cam_feats``; ``generator`` draws the head's train-mode
        dropout masks; ``trunk`` is a callable run in place of
        ``backbone`` (the same contract; the predictor's folded trunk).
        Returns pred_pose (B, 24, 3, 3), pred_pose_6d, pred_shape,
        pred_cam, smpl_vertices, smpl_joints3d, smpl_joints2d,
        pred_cam_t."""
        x = images.permute(0, 3, 1, 2)
        if self.cols:
            x = x[..., self.cols:-self.cols]
        with compute_dtype(self.dtype, images.device.type):
            features = (trunk or self.backbone)(x)
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
