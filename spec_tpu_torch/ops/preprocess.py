"""On-device image preprocessing: stage-1 min-side resize, and the batched
SPIN crop + resize + normalize of stage 2 (port of
``spec_tpu/ops/preprocess.py``).

The crop samples each output pixel bilinearly at
``(dst + 0.5) * box / res - 0.5`` in box coordinates, clamps the taps to
the box edges as cv2.resize does on the zero-padded box slice, and maps
them into the frame with zero padding outside it. It is written as
gathers over the frame on its device; the JAX package's one-hot matmul
form only dodged the TPU's gather lowering.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spec_tpu_torch.core import constants as C
from spec_tpu_torch.data.transforms import transform_point
from spec_tpu_torch.utils.graphs import device_constant
from spec_tpu_torch.utils.precision import fp32_precision


def spin_crop_corners(centers, scales, res: int = 224) -> np.ndarray:
    """Integer crop corners (N, 4) [ulx, uly, brx, bry] via the exact
    host transform (float64), like ``spec_tpu.native.spin_crop_batch``:
    the caller's center/scale dtype is kept."""
    centers = np.asarray(centers).reshape(-1, 2)
    scales = np.asarray(scales).reshape(-1)
    out = np.empty((len(scales), 4), np.int32)
    for k in range(len(scales)):
        ul = transform_point([1, 1], centers[k], float(scales[k]),
                             [res, res], invert=1) - 1
        br = transform_point([res + 1, res + 1], centers[k],
                             float(scales[k]), [res, res], invert=1) - 1
        out[k] = [ul[0], ul[1], br[0], br[1]]
    return out


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., 3) -> ImageNet-normalized."""
    mean = device_constant(C.IMG_NORM_MEAN, x.device)
    std = device_constant(C.IMG_NORM_STD, x.device)
    return (x - mean) / std


def normalize_u8(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., 3) -> float32 ImageNet-normalized."""
    return normalize_image(img_u8.float() / 255.0)


def _axis_taps(ul: torch.Tensor, box: torch.Tensor, size: int, res: int):
    """Bilinear taps along one axis with cv2 box-edge clamping.

    ul, box: (B, 1) float32. Returns frame indices i0, i1 (B, res) long,
    clamped into [0, size), their in-frame masks m0, m1 (B, res) float32,
    and the fraction f (B, res): value = (1-f) * m0 * x[i0] + f * m1 * x[i1].
    """
    r = torch.arange(res, dtype=torch.float32, device=ul.device) + 0.5
    hi = (box - 1.0).clamp_min(0.0)
    xb = torch.minimum((r[None, :] * box / res - 0.5).clamp_min(0.0), hi)
    c0 = torch.floor(xb)
    f = xb - c0
    c1 = torch.minimum(c0 + 1.0, hi)
    X0, X1 = ul + c0, ul + c1
    m0 = ((X0 >= 0) & (X0 < size)).float()
    m1 = ((X1 >= 0) & (X1 < size)).float()
    i0 = X0.clamp(0, size - 1).long()
    i1 = X1.clamp(0, size - 1).long()
    return i0, i1, m0, m1, f


def crop_resize_normalize(
    frames: torch.Tensor,    # (F, H, W, 3) float32 RGB in [0, 255]
    corners: torch.Tensor,   # (B, 4) int [ulx, uly, brx, bry]
    res: int = 224,
    normalize: bool = True,
    frame_index: torch.Tensor | None = None,   # (B,) int, box -> frame
) -> torch.Tensor:
    """-> (B, res, res, 3) float32: /255 and, with ``normalize``,
    ImageNet-normalized. Taps outside the frame read zero (zero padding).
    Runs on the frames' device. Box b crops frame ``frame_index[b]``
    (default: frame b, with F = B), so one call crops many boxes of
    several frames of one size."""
    H, W = frames.shape[1:3]
    B = corners.shape[0]
    corners = corners.to(device=frames.device, dtype=torch.float32)
    ulx, uly = corners[:, 0:1], corners[:, 1:2]
    y0, y1, my0, my1, fy = _axis_taps(uly, corners[:, 3:4] - uly, H, res)
    x0, x1, mx0, mx1, fx = _axis_taps(ulx, corners[:, 2:3] - ulx, W, res)

    bi = (torch.arange(B, device=frames.device) if frame_index is None
          else frame_index.to(device=frames.device, dtype=torch.long)
          )[:, None, None]
    wy0 = ((1.0 - fy) * my0)[:, :, None, None]          # (B, res, 1, 1)
    wy1 = (fy * my1)[:, :, None, None]
    wx0 = ((1.0 - fx) * mx0)[:, None, :, None]          # (B, 1, res, 1)
    wx1 = (fx * mx1)[:, None, :, None]

    def rows(yi):
        return (wx0 * frames[bi, yi[:, :, None], x0[:, None, :]]
                + wx1 * frames[bi, yi[:, :, None], x1[:, None, :]])

    v = (wy0 * rows(y0) + wy1 * rows(y1)) / 255.0
    return normalize_image(v) if normalize else v


def resize_min_side(img_u8: torch.Tensor, min_size: int) -> torch.Tensor:
    """(H, W, 3) uint8, or a batch (N, H, W, 3) of one size -> uint8 with
    the short side at ``min_size``, aspect kept: torchvision
    ``Resize(min_size)`` on a PIL image (``Image.BILINEAR``), computed on
    the image's device with the antialiased bilinear filter, then rounded
    and clamped to uint8. A batch resizes each image as alone."""
    h, w = img_u8.shape[-3:-1]
    s = min_size / min(w, h)
    out_h, out_w = round(h * s), round(w * s)
    if (out_h, out_w) == (h, w):
        return img_u8
    x = img_u8.reshape(-1, h, w, 3).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                      align_corners=False, antialias=True)
    y = y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return y.reshape(*img_u8.shape[:-3], out_h, out_w, 3)


def device_jitter_normalize(img_u8: torch.Tensor, A: torch.Tensor,
                            b: torch.Tensor,
                            true_shape: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """CamCalib training's ColorJitter on the device: per image the
    affine ``x -> A @ x + b`` (sampled on the host), clipped to [0, 255],
    then ImageNet-normalized. img_u8 (B, H, W, 3) raw frames, A (B, 3,
    3), b (B, 3). ``true_shape`` (B, 2): each image's unpadded (h, w);
    the pad mask is rebuilt here from it and zeroes the padding after
    normalization, so padded pixels stay exactly 0.0."""
    with fp32_precision():
        x = torch.einsum('bij,bhwj->bhwi', A.float(), img_u8.float())
    x = x + b.float()[:, None, None, :]
    x = normalize_image(torch.clamp(x, 0.0, 255.0) / 255.0)
    if true_shape is not None:
        H, W = x.shape[1], x.shape[2]
        ts = true_shape.to(x.device)
        rows = (torch.arange(H, device=x.device)[None, :]
                < ts[:, 0, None])                                # (B, H)
        cols = (torch.arange(W, device=x.device)[None, :]
                < ts[:, 1, None])                                # (B, W)
        mask = rows[:, :, None] & cols[:, None, :]
        x = x * mask[..., None].to(x.dtype)
    return x
