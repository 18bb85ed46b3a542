"""SPEC's image side in plain PyTorch and NumPy: the stage-1 resize,
ImageNet normalization, the softargmax decode of CamCalib's bins, SPIN's
person crop, and the keyframe rule of a stream (a frame is a keyframe
every ``every`` frames, or where its gray histogram jumps)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# CamCalib's angle ranges (radians) over its 256 bins.
VFOV_RANGE, PITCH_RANGE, ROLL_RANGE = (0.2617, 2.1), (-0.6, 0.6), (-0.6,
                                                                   0.6)


def normalize(x01_nhwc: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB NHWC -> ImageNet-normalized NCHW."""
    mean = torch.tensor(MEAN, device=x01_nhwc.device)
    std = torch.tensor(STD, device=x01_nhwc.device)
    return ((x01_nhwc - mean) / std).permute(0, 3, 1, 2)


def resize_min_side(frame_u8: torch.Tensor, min_size: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> uint8 with the short side at ``min_size``
    (torchvision's ``Resize`` of a PIL image: antialiased bilinear, then
    rounded)."""
    h, w = frame_u8.shape[:2]
    s = min_size / min(h, w)
    oh, ow = round(h * s), round(w * s)
    if (oh, ow) == (h, w):
        return frame_u8
    x = frame_u8.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(oh, ow), mode='bilinear', align_corners=False,
                      antialias=True)
    return y.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)


def softargmax_angle(logits: torch.Tensor, lo: float, hi: float):
    """The expected bin index under the softmax, mapped linearly from
    [0, bins - 1] onto [lo, hi]."""
    p = torch.softmax(logits, dim=-1)
    idx = torch.arange(logits.shape[-1], device=logits.device,
                       dtype=logits.dtype)
    return lo + (hi - lo) * (p * idx).sum(-1) / (logits.shape[-1] - 1)


def spin_corners(center, scale, res: int):
    """SPIN's crop box of a person (center (2,), scale = side / 200):
    integer [ulx, uly, brx, bry], from the inverse of the box-to-crop
    map, 1-based as SPIN computes it. The map's offsets are computed in
    the center's own precision (float32 boxes: float32, as NumPy promotes
    SPIN's expression), so the integer box is SPIN's to the pixel."""
    h = 200.0 * float(scale)
    t = np.zeros((3, 3))
    t[0, 0] = t[1, 1] = res / h
    t[0, 2] = res * (-center[0] / h + 0.5)
    t[1, 2] = res * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    inv = np.linalg.inv(t)

    def back(p):
        q = inv @ np.array([p - 1.0, p - 1.0, 1.0])
        return q[:2].astype(int) + 1 - 1

    ul, br = back(1.0), back(res + 1.0)
    return int(ul[0]), int(ul[1]), int(br[0]), int(br[1])


def crop(frame: torch.Tensor, corners, res: int) -> torch.Tensor:
    """(H, W, 3) float frame -> the (res, res, 3) crop: the box cut out of
    the zero-padded frame and resized bilinearly (half-pixel centers, no
    antialias), as SPIN's ``crop`` with cv2."""
    ulx, uly, brx, bry = corners
    H, W = frame.shape[:2]
    box = torch.zeros((bry - uly, brx - ulx, 3), device=frame.device)
    y0, y1 = max(0, uly), min(H, bry)
    x0, x1 = max(0, ulx), min(W, brx)
    if y1 > y0 and x1 > x0:
        box[y0 - uly:y1 - uly, x0 - ulx:x1 - ulx] = frame[y0:y1, x0:x1]
    out = F.interpolate(box.permute(2, 0, 1)[None], size=(res, res),
                        mode='bilinear', align_corners=False)
    return out[0].permute(1, 2, 0)


def signature(frame: np.ndarray, bins: int = 32, side: int = 64):
    """Normalized 32-bin gray histogram of a strided ~64-px copy."""
    a = np.asarray(frame).mean(axis=2)
    step = max(1, -(-max(a.shape[:2]) // side))
    hist, _ = np.histogram(a[::step, ::step], bins=bins, range=(0.0, 256.0))
    return hist.astype(np.float32) / max(int(hist.sum()), 1)


def keyframes(frames, start: int, every: int, threshold: float,
              prev_signature=None) -> list:
    """Indices of the keyframes among ``frames``, the stream's frames
    ``start``, ``start + 1``, ...: every ``every``-th frame, and any whose
    histogram lies more than ``threshold`` (L1) from the previous one's.
    The stream's first frame is always one."""
    keys, prev = [], prev_signature
    for i, fr in enumerate(frames):
        sig = signature(fr) if threshold > 0 else None
        cut = (prev is not None and sig is not None
               and float(np.abs(prev - sig).sum()) > threshold)
        if (start + i) % every == 0 or cut or (start == 0 and i == 0):
            keys.append(i)
        prev = sig
    return keys
