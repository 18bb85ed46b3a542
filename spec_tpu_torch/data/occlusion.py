"""Synthetic occlusion augmentation (port of
``spec_tpu/data/occlusion.py``, the counterpart of
``pare.dataset.coco_occlusion``).

An occluder bank is a list of RGBA uint8 object cutouts (COCO instances
or Pascal VOC segments) in a pickle or npz, the artifact the reference
downloads. Occluders are pasted onto the host crop before normalization.
cv2 is imported where an occluder is resized (the machine with the card
has none).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np


def load_occluders(path: str) -> List[np.ndarray]:
    """An occluder bank (.pkl list of RGBA uint8 arrays, or .npz)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith('.npz'):
        data = np.load(path, allow_pickle=True)
        return list(data[data.files[0]])
    with open(path, 'rb') as f:
        return list(pickle.load(f))


def paste_occluder(img: np.ndarray, occluder: np.ndarray,
                   center_xy, scale: float) -> np.ndarray:
    """Alpha-composite one occluder at ``center_xy``, resized by
    ``scale``, into ``img`` (in place) and return it."""
    import cv2

    h, w = occluder.shape[:2]
    nw, nh = max(2, int(w * scale)), max(2, int(h * scale))
    occ = cv2.resize(occluder.astype(np.float32), (nw, nh),
                     interpolation=cv2.INTER_LINEAR)
    rgb, alpha = occ[..., :3], occ[..., 3:4] / 255.0

    x0 = int(center_xy[0] - nw / 2)
    y0 = int(center_xy[1] - nh / 2)
    x1, y1 = x0 + nw, y0 + nh
    H, W = img.shape[:2]
    sx0, sy0 = max(0, -x0), max(0, -y0)
    x0, y0 = max(0, x0), max(0, y0)
    x1, y1 = min(W, x1), min(H, y1)
    if x1 <= x0 or y1 <= y0:
        return img
    reg = img[y0:y1, x0:x1]
    o_rgb = rgb[sy0:sy0 + (y1 - y0), sx0:sx0 + (x1 - x0)]
    o_a = alpha[sy0:sy0 + (y1 - y0), sx0:sx0 + (x1 - x0)]
    img[y0:y1, x0:x1] = o_a * o_rgb + (1 - o_a) * reg
    return img


def occlude_with_objects(
    img: np.ndarray,
    occluders: List[np.ndarray],
    rng: Optional[np.random.RandomState] = None,
    kp2d: Optional[np.ndarray] = None,
    img_size: int = 224,
    count_range=(1, 8),
) -> np.ndarray:
    """Paste 1..7 random occluders scaled to the crop (width ~ U(0.2,
    0.5) of its side), placed uniformly or, half the time when
    keypoints are given, on a visible keypoint."""
    rng = rng or np.random
    img = img.copy()
    width_height = np.array([img.shape[1], img.shape[0]], np.float32)
    count = rng.randint(count_range[0], count_range[1])
    for _ in range(count):
        occ = occluders[rng.randint(len(occluders))]
        target_w = rng.uniform(0.2, 0.5) * img_size
        scale = target_w / max(occ.shape[1], 1)
        if kp2d is not None and len(kp2d) and rng.rand() < 0.5:
            vis = kp2d[kp2d[:, 2] > 0.5] if kp2d.shape[1] > 2 else kp2d
            if len(vis):
                j = vis[rng.randint(len(vis))]
                center = ((j[:2] + 1) / 2.0 * width_height)
            else:
                center = rng.uniform([0, 0], width_height)
        else:
            center = rng.uniform([0, 0], width_height)
        img = paste_occluder(img, occ, center, scale)
    return img
