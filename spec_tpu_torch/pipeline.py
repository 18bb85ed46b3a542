"""The e2e device pipeline: raw frames in, meshes and cameras out, with no
host round trip between the stages. Port of ``bench.build_pipeline``.

uint8-range frames -> ImageNet normalize -> stage 1 (CamCalib ResNet-50)
-> softargmax bin decode -> focal length, pitch/roll rotation and
intrinsics -> on-device SPIN crop + resize + normalize -> HMR ResNet-50
with the camera-conditioned head -> SMPL through the fused LBS kernel.

Stage 1 runs either the CamCalib module (``stage1='module'``, the JAX
``'flax'`` trunk) or :class:`~spec_tpu_torch.models.backbones.
fused_resnet.FusedResNet` over the same backbone with the mean pool and
the three heads in the compute dtype (``stage1='fused'``, which runs the
bottleneck-chain kernel K3).

Differences from ``bench.build_pipeline``: the weights live in the
modules (``build_pipeline`` takes optional state_dicts, else a random
init from fixed seeds), so the pipeline takes no per-call variables;
``device`` places modules and assets; ``stage1='flax'`` is named
``'module'``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from spec_tpu_torch.core import bins
from spec_tpu_torch.core import geometry as G
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.models.backbones.fused_resnet import FusedResNet
from spec_tpu_torch.models.camcalib import HEADS, CameraRegressorNetwork
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.ops.preprocess import (
    crop_resize_normalize,
    normalize_image,
)
from spec_tpu_torch.utils.precision import fp32_precision

STAGE1 = ('module', 'fused')


def _fused_stage1(camcalib: CameraRegressorNetwork, dtype: torch.dtype):
    """Folded-BN trunk + mean pool + the three heads in ``dtype``,
    logits out float32 (``bench.py`` ``camcalib_fwd``)."""
    trunk = FusedResNet(camcalib.backbone, dtype=dtype)
    heads = [(getattr(camcalib, n).weight.detach().to(dtype),
              getattr(camcalib, n).bias.detach().to(dtype)) for n in HEADS]

    def forward(frames: torch.Tensor):
        pooled = trunk(frames).mean(dim=(1, 2))
        with fp32_precision():
            return tuple(F.linear(pooled.to(dtype), w, b).float()
                         for w, b in heads)

    return forward


def build_pipeline(compute_dtype: torch.dtype = torch.bfloat16,
                   img_res: int = 224, stage1: str = 'module',
                   device: str | torch.device = 'cuda',
                   camcalib_state: Optional[dict] = None,
                   spec_state: Optional[dict] = None):
    """-> (camcalib, spec, assets, pipeline).

    camcalib_state / spec_state: state_dicts for the ResNet-50 CamCalib
    and HMR (``use_cam_feats``) modules; None gives the random init of
    ``SpecPredictor`` (seeds 0 and 1). Assets are the synthetic SMPL
    assets with K1's packed operands. ``pipeline(raw_frames, corners,
    bbox_center, bbox_scale)`` takes (B, H, W, 3) float32 RGB in
    [0, 255], (B, 4) int32 SPIN crop corners (one person per frame),
    (B, 2) and (B,) and returns (vertices, joints2d, pred_cam_t, vfov,
    pitch, roll).
    """
    if stage1 not in STAGE1:
        raise ValueError(f'stage1 must be one of {STAGE1}, got {stage1!r}')
    device = torch.device(device)
    assets = S.with_packed_lbs(S.create_test_assets().to(device))
    camcalib = CameraRegressorNetwork(backbone='resnet50',
                                      dtype=compute_dtype)
    spec = HMR(backbone='resnet50', use_cam=True, use_cam_feats=True,
               img_res=img_res, dtype=compute_dtype)
    for model, state, seed in ((camcalib, camcalib_state, 0),
                               (spec, spec_state, 1)):
        if state is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state)
        model.to(device).eval()
    stage1_fwd = (_fused_stage1(camcalib, compute_dtype)
                  if stage1 == 'fused' else camcalib)

    @torch.inference_mode()
    def pipeline(raw_frames, corners, bbox_center, bbox_scale):
        B, H, W, _ = raw_frames.shape
        img_h = torch.full((B,), float(H), device=raw_frames.device)
        img_w = torch.full((B,), float(W), device=raw_frames.device)

        frames = normalize_image(raw_frames / 255.0)
        vfov, pitch, roll = bins.convert_preds_to_angles(
            *stage1_fwd(frames), loss_type='softargmax_biased_l2')
        with fp32_precision():
            f_pix = G.focal_length_from_vfov(vfov, img_h)
            cam_rotmat = G.euler_to_rotmat(
                torch.stack([pitch, torch.zeros_like(pitch), roll], -1))
            K = G.build_cam_intrinsics(f_pix, img_w, img_h)

        crops = crop_resize_normalize(raw_frames, corners, res=img_res)
        out = spec(assets, crops, cam_rotmat, K, bbox_scale, bbox_center,
                   img_w, img_h)
        return (out['smpl_vertices'], out['smpl_joints2d'],
                out['pred_cam_t'], vfov, pitch, roll)

    return camcalib, spec, assets, pipeline
