"""Horizon-line and keypoint drawing for the demos, and CamCalib's error
CDF plot (port of those parts of ``spec_tpu/utils/vis.py``).

For a pinhole camera with vertical fov, pitch and roll, the horizon
crosses the vertical image midline at ``ctr = 0.5 - 0.5 * tan(pitch) /
tan(vfov / 2)`` (a fraction of the height) and tilts with the roll: its
ends at the left and right edges are offset by ``-/+ w * tan(roll) / 2``.
cv2 and matplotlib are imported inside the functions.
"""

from __future__ import annotations

import numpy as np


def horizon_points(vfov, pitch, roll, img_w, img_h):
    """Left/right horizon intersections with the image borders ((2,2) px)."""
    ctr = img_h * (0.5 - 0.5 * np.tan(pitch) / np.tan(vfov / 2.0))
    dy = img_w * np.tan(roll) / 2.0
    return np.array([[0.0, ctr - dy], [img_w, ctr + dy]], np.float32)


def draw_horizon_line(img, vfov, pitch, roll, color=(0, 255, 255),
                      thickness=None, debug_text=True):
    """Draw the horizon on an RGB uint8/float image."""
    import cv2

    out = np.ascontiguousarray(img.astype(np.uint8))
    h, w = out.shape[:2]
    pts = horizon_points(vfov, pitch, roll, w, h).astype(int)
    t = thickness or max(2, h // 200)
    cv2.line(out, tuple(pts[0]), tuple(pts[1]), color, t)
    if debug_text:
        txt = (f'vfov={np.degrees(vfov):.1f} pitch={np.degrees(pitch):.1f} '
               f'roll={np.degrees(roll):.1f}')
        cv2.putText(out, txt, (10, max(20, h // 20)),
                    cv2.FONT_HERSHEY_SIMPLEX, max(0.4, h / 1500.0),
                    (255, 40, 40), 2)
    return out


def plot_error_cdf(errors_deg, out_path, label='error'):
    """The cumulative error plot of CamCalib's validation: fraction of
    images against angular error in degrees, written to ``out_path``
    (matplotlib, imported here)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    errors = np.sort(np.asarray(errors_deg))
    frac = np.arange(1, len(errors) + 1) / len(errors)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(errors, frac)
    ax.set_xlabel(f'{label} (degrees)')
    ax.set_ylabel('fraction of images')
    ax.set_ylim(0, 1)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)


def gt_vs_pred_horizon(img, gt_angles, pred_angles):
    """GT (green) and predicted (yellow) horizons on one image."""
    out = draw_horizon_line(img, *gt_angles, color=(0, 255, 0),
                            debug_text=False)
    return draw_horizon_line(out, *pred_angles, color=(255, 255, 0),
                             debug_text=False)


def draw_skeleton(img, kp2d, color=(0, 255, 0), radius=None):
    """Scatter 2D keypoints (pixel coords, (J,2) or (J,3) with conf)."""
    import cv2

    out = np.ascontiguousarray(img.astype(np.uint8))
    r = radius or max(2, out.shape[0] // 200)
    for j in kp2d:
        if len(j) > 2 and j[2] <= 0:
            continue
        cv2.circle(out, (int(j[0]), int(j[1])), r, color, -1)
    return out
