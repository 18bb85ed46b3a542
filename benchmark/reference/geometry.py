"""Rotations and cameras of SPEC, in plain PyTorch float32 (SPIN's and
SPEC's published formulas)."""

from __future__ import annotations

import torch

EPS = 1e-8


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt; the two 3-vectors are the
    first two columns."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / a1.norm(dim=-1, keepdim=True).clamp_min(EPS)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / b2.norm(dim=-1, keepdim=True).clamp_min(EPS)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], dim=-1)


def euler_to_rotmat(pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """``Rx(pitch) @ Rz(roll)`` (zero yaw), (B,) each -> (B, 3, 3)."""
    cp, sp, cr, sr = pitch.cos(), pitch.sin(), roll.cos(), roll.sin()
    o, z = torch.ones_like(cp), torch.zeros_like(cp)
    rx = torch.stack([o, z, z, z, cp, -sp, z, sp, cp], -1).reshape(-1, 3, 3)
    rz = torch.stack([cr, -sr, z, sr, cr, z, z, z, o], -1).reshape(-1, 3, 3)
    return rx @ rz


def full_translation(cam, center, scale, img_w, img_h, focal, crop_res):
    """SPEC's crop weak-perspective (s, tx, ty) -> camera translation in
    the full frame: ``tz = 2 f / (s b)`` with the box side ``b = 200
    scale``, plus the box's offset from the principal point."""
    s = cam[:, 0].clamp_min(EPS)
    sb = s * scale * 200.0
    return torch.stack([cam[:, 1] + 2.0 * (center[:, 0] - img_w / 2.0) / sb,
                        cam[:, 2] + 2.0 * (center[:, 1] - img_h / 2.0) / sb,
                        2.0 * focal / sb], dim=-1)


def project(points, rotation, translation, focal, img_w, img_h):
    """Pixels of ``K (R X + t)`` after the perspective divide, K with
    fx = fy = ``focal`` and the principal point at the frame's center.
    points (B, N, 3) -> (B, N, 2)."""
    p = points @ rotation.transpose(1, 2) + translation[:, None]
    z = p[..., 2:3].clamp_min(EPS)
    uv = p[..., :2] / z * focal[:, None, None]
    return uv + torch.stack([img_w, img_h], -1)[:, None] / 2.0
