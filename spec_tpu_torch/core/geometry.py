"""Rotation and camera math on the inference path (torch twin of the
matching subset of ``spec_tpu/core/geometry.py``).

Same conventions as the reference: row-major rotation matrices acting on
column vectors (``x' = R x``), camera rotation ``R = Rx(pitch) @ Ry(yaw)
@ Rz(roll)``, axis-angle as axis * angle. Every function runs in fp32
with TF32 off (:func:`fp32_matmuls`), whatever the caller's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_tpu_torch.utils.precision import exact_fp32_fn, fp32_matmuls

_EPS = 1e-8


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> (..., 3, 3) by Gram-Schmidt; ``x[..., :3]``
    and ``x[..., 3:]`` are the first two columns (SPIN/HMR convention)."""
    x = x.float()
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(
        _EPS)
    proj = (b1 * a2).sum(dim=-1, keepdim=True)
    b2 = a2 - proj * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True).clamp_min(
        _EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rot6d_to_rotmat` (drops the third column)."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


@fp32_matmuls
def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3). Below
    |aa|^2 = 1e-8 the first-order form ``I + [aa]_x`` is used."""
    aa = aa.float()
    sq = (aa * aa).sum(dim=-1, keepdim=True)
    small = sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    axis = aa / theta
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R_exact = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    R_taylor = eye + K
    return torch.where(small[..., None], R_taylor, R_exact)


@fp32_matmuls
def euler_to_rotmat(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) ordered (pitch, yaw, roll) -> rotation
    matrix ``Rx(pitch) @ Ry(yaw) @ Rz(roll)``."""
    euler = euler.float()
    pitch, yaw, roll = euler[..., 0], euler[..., 1], euler[..., 2]
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cr, sr = torch.cos(roll), torch.sin(roll)
    one = torch.ones_like(cp)
    zero = torch.zeros_like(cp)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rx = mat([[one, zero, zero], [zero, cp, -sp], [zero, sp, cp]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = mat([[cr, -sr, zero], [sr, cr, zero], [zero, zero, one]])
    return Rx @ Ry @ Rz


@fp32_matmuls
def perspective_projection(
    points: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    cam_intrinsics: torch.Tensor,
) -> torch.Tensor:
    """``K @ (R @ X + t)`` with perspective divide.

    points (B, N, 3), rotation (B, 3, 3), translation (B, 3),
    cam_intrinsics (B, 3, 3) -> pixels (B, N, 2).
    """
    cam_pts = torch.einsum('bij,bnj->bni', rotation.float(), points.float())
    cam_pts = cam_pts + translation[:, None, :].float()
    z = cam_pts[..., 2:3].clamp_min(_EPS)
    proj = torch.einsum('bij,bnj->bni', cam_intrinsics.float(), cam_pts / z)
    return proj[..., :2]


def weak_perspective_to_full_translation(
    cam: torch.Tensor,
    bbox_center: torch.Tensor,
    bbox_scale: torch.Tensor,
    img_w: torch.Tensor,
    img_h: torch.Tensor,
    focal_length: torch.Tensor,
    crop_res: int = 224,
) -> torch.Tensor:
    """Crop-frame weak-perspective (s, tx, ty) -> full-image camera
    translation (B, 3): ``tz = 2 f / (s b)`` with bbox side
    ``b = scale * 200``, plus the bbox offset from the principal point."""
    s = cam[:, 0].float().clamp_min(_EPS)
    tx, ty = cam[:, 1].float(), cam[:, 2].float()
    b = bbox_scale.float() * 200.0
    tz = 2.0 * focal_length.float() / (s * b)
    cx = 2.0 * (bbox_center[:, 0].float() - img_w.float() / 2.0) / (s * b)
    cy = 2.0 * (bbox_center[:, 1].float() - img_h.float() / 2.0) / (s * b)
    return torch.stack([tx + cx, ty + cy, tz], dim=-1)


def weak_perspective_cam_t(cam: torch.Tensor, focal_length: float = 5000.0,
                           img_res: int = 224) -> torch.Tensor:
    """Weak-perspective (s, tx, ty) -> ``(tx, ty, 2f / (res * s))``."""
    s = cam[:, 0].clamp_min(_EPS)
    return torch.stack(
        [cam[:, 1], cam[:, 2], 2.0 * focal_length / (img_res * s)], dim=-1)


def weak_perspective_projection(
    points: torch.Tensor, cam: torch.Tensor, focal_length: float = 5000.0,
    img_res: int = 224,
) -> torch.Tensor:
    """Crop-frame projection of the non-cam SMPL head, normalized to
    [-1, 1]."""
    B = points.shape[0]
    t = weak_perspective_cam_t(cam, focal_length, img_res)
    K = torch.zeros((B, 3, 3), dtype=torch.float32, device=points.device)
    K[:, 0, 0] = focal_length
    K[:, 1, 1] = focal_length
    K[:, 2, 2] = 1.0
    K[:, 0, 2] = img_res / 2.0
    K[:, 1, 2] = img_res / 2.0
    eye = torch.eye(3, dtype=torch.float32, device=points.device).expand(
        B, 3, 3)
    pix = perspective_projection(points, eye, t, K)
    return pix / (img_res / 2.0) - 1.0


def focal_length_from_vfov(vfov: torch.Tensor,
                           img_h: torch.Tensor) -> torch.Tensor:
    """f_pix = (H / 2) / tan(vfov / 2)."""
    return img_h / 2.0 / torch.tan(vfov / 2.0)


def build_cam_intrinsics(focal_length: torch.Tensor, img_w: torch.Tensor,
                         img_h: torch.Tensor) -> torch.Tensor:
    """K (B, 3, 3) with fx = fy = f and the principal point at the image
    center. Like the reference, K[2, 2] stays 0: only the first two rows
    are used by the projection's perspective divide."""
    f = torch.as_tensor(focal_length, dtype=torch.float32)
    K = torch.zeros((f.shape[0], 3, 3), dtype=torch.float32,
                    device=f.device)
    K[:, 0, 0] = f
    K[:, 1, 1] = f
    K[:, 0, 2] = torch.as_tensor(img_w, dtype=torch.float32,
                                 device=f.device) / 2.0
    K[:, 1, 2] = torch.as_tensor(img_h, dtype=torch.float32,
                                 device=f.device) / 2.0
    return K


# ---------------------------------------------------------------------------
# The evaluation path's additions: Procrustes, the rotation log map and
# the camera helpers of the eval data and offline metrics.
# ---------------------------------------------------------------------------


@exact_fp32_fn
def procrustes_align(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Batched similarity (Procrustes) alignment of S1 onto S2: returns
    ``s R S1 + t`` minimizing the Frobenius distance to S2, the
    alignment of PA-MPJPE. S1, S2 (B, N, 3) -> (B, N, 3), fp32.

    A 3x3 SVD per sample (``torch.linalg.svd``) with the reflection
    guard ``diag(1, 1, sign det(V U^T))``."""
    X1 = S1.float().transpose(-1, -2)
    X2 = S2.float().transpose(-1, -2)
    mu1 = X1.mean(dim=-1, keepdim=True)
    mu2 = X2.mean(dim=-1, keepdim=True)
    X1c = X1 - mu1
    X2c = X2 - mu2
    var1 = (X1c ** 2).sum(dim=(-2, -1))
    K = X1c @ X2c.transpose(-1, -2)              # (B, 3, 3) covariance
    U, s, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    z = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign],
                    dim=-1)
    R = (V * z[..., None, :]) @ U.transpose(-1, -2)
    scale = (s * z).sum(dim=-1) / var1.clamp_min(_EPS)
    t = mu2 - scale[..., None, None] * (R @ mu1)
    X1_hat = (scale[..., None, None] * (R @ X1c)
              + scale[..., None, None] * (R @ mu1) + t)
    return X1_hat.transpose(-1, -2)


@fp32_matmuls
def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z) with
    w >= 0: Shepperd's method without branches (all four candidate
    constructions, the best-conditioned one picked per matrix)."""
    R = R.float()
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(v.clamp_min(_EPS))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)

    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = scores.argmax(dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)          # (..., 4, 4)
    q = torch.gather(cands, -2,
                     best[..., None, None].expand(*best.shape, 1, 4))[..., 0,
                                                                      :]
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1,
                                        keepdim=True).clamp_min(_EPS)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> axis-angle (..., 3); below a
    half-angle sine of 1e-6, ``aa = 2 xyz``."""
    w = q[..., 0].clamp(-1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    small = sin_half < 1e-6
    axis = xyz / torch.where(small, torch.ones_like(sin_half), sin_half)
    return torch.where(small, 2.0 * xyz, axis * theta)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), through the
    quaternion (robust near 0 and pi)."""
    return quat_to_aa(rotmat_to_quat(R))


def vfov_from_focal_length(f_pix: torch.Tensor,
                           img_h: torch.Tensor) -> torch.Tensor:
    """vfov = 2 atan(H / (2 f))."""
    return 2.0 * torch.atan(img_h / (2.0 * f_pix))


def euler_pitch_roll_np(pitch: float, roll: float) -> np.ndarray:
    """Host (numpy) ``euler_to_rotmat([pitch, 0, roll])``: ``Rx(pitch) @
    Rz(roll)`` in float32, the camera rotation built from CamCalib's
    pitch and roll."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
    return (Rx @ Rz).astype(np.float32)
