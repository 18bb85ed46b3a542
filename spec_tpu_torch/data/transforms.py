"""Host-side SPIN crop geometry (the rot = 0 subset of
``spec_tpu/data/transforms.py``), numpy only.

A bbox is (center, scale) with side = scale * 200 px; the crop maps that
box to a res x res image. The corner arithmetic stays in float64 exactly
as in the reference: the integer truncation of the crop corners sits on
knife edges that float32 intermediates move.
"""

from __future__ import annotations

import numpy as np

BBOX_SIDE = 200.0  # SPIN convention: bbox pixel side = scale * 200


def get_transform(center, scale, res):
    """3x3 float64 matrix mapping original-image points into the
    res x res crop (SPIN ``get_transform`` without rotation)."""
    h = BBOX_SIDE * scale
    t = np.zeros((3, 3), dtype=np.float64)
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    return t


def transform_point(pt, center, scale, res, invert=0):
    """Map a (2,) point image <-> crop (SPIN ``transform``), 1-based:
    callers pass pt + 1 and get a 1-based integer result."""
    t = get_transform(center, scale, res)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1, pt[1] - 1, 1.0])
    return new_pt[:2].astype(int) + 1
