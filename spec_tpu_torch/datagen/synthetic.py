"""Synthetic horizon images: a learnable stand-in for the pano crops
(port of ``spec_tpu/datagen/synthetic.py``, the same draws).

CamCalib's task is literally "read the horizon from the image"
(reference ``camcalib/model.py`` trained on pano-derived crops), so a
two-tone sky/ground image whose ONLY signal is the pitch/roll-determined
horizon line (geometry = ``utils/vis.horizon_points`` = reference
``camcalib/vis_utils.py:86-88``) is the minimal dataset the network must
be able to learn.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


def render_horizon_batch(
    rng: np.random.RandomState,
    n: int,
    res: Union[int, Tuple[int, int]] = 64,
    vfov: float = 1.2,
    angle_range: float = 0.35,
    noise: float = 0.05,
):
    """(n, H, W, 3) float32 two-tone sky/ground images + (pitch, roll).

    ``vfov`` is fixed per batch: a bare horizon line does not identify
    the field of view, so only pitch/roll are learnable targets.
    Pitch/roll are uniform in ±``angle_range`` rad.
    """
    h, w = (res, res) if isinstance(res, int) else res
    pitch = (rng.rand(n) * 2 * angle_range - angle_range).astype(np.float32)
    roll = (rng.rand(n) * 2 * angle_range - angle_range).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        # Horizon midline crossing + per-column roll offset (the
        # reference's horizon geometry, vis_utils.py:86-88).
        ctr = h * (0.5 - 0.5 * np.tan(pitch[i]) / np.tan(vfov / 2))
        line_y = ctr + (xs - w / 2) * np.tan(roll[i])
        sky = (ys < line_y).astype(np.float32)
        img = np.stack([0.8 * sky + 0.1, 0.6 * sky + 0.2,
                        0.2 * sky + 0.5], -1)
        imgs[i] = img + rng.randn(h, w, 3).astype(np.float32) * noise
    return imgs, pitch, roll
