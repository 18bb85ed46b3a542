"""Person-box conventions (``spec_tpu/data/detection.py`` subset)."""

from __future__ import annotations

import numpy as np


def bbox_to_center_scale(bboxes: np.ndarray, scale_factor: float = 1.0):
    """[cx, cy, w, h] -> (center (N, 2), scale (N,)) float32 with the SPIN
    convention scale = max_side * scale_factor / 200."""
    center = bboxes[:, :2].astype(np.float32)
    scale = (np.maximum(bboxes[:, 2], bboxes[:, 3])
             * scale_factor / 200.0).astype(np.float32)
    return center, scale
