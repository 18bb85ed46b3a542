"""Person boxes for the demos and the server (the host part of
``spec_tpu/data/detection.py``).

Boxes are ``[cx, cy, w, h]`` in pixels. They come from a precomputed
file (:func:`load_bboxes_file`) or one whole-image box per frame
(:func:`full_image_bboxes`). The in-process YOLOv3 is not ported yet
(``ROADMAP.md`` §1 item 10).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np


def load_bboxes_file(path: str) -> Dict[str, np.ndarray]:
    """Load {image_basename: (N, 4) [cx, cy, w, h]} detections.

    json: {"img.jpg": [[cx,cy,w,h], ...], ...}
    npz:  arrays keyed by basename.
    """
    if path.endswith('.json'):
        with open(path) as f:
            raw = json.load(f)
        return {k: np.asarray(v, np.float32).reshape(-1, 4)
                for k, v in raw.items()}
    data = np.load(path, allow_pickle=True)
    return {k: np.asarray(data[k], np.float32).reshape(-1, 4)
            for k in data.files}


def full_image_bboxes(image_shapes: Dict[str, tuple],
                      margin: float = 0.05) -> Dict[str, np.ndarray]:
    """One centered square box per image ({name: (h, w)}) covering
    (1 - 2 * margin) of the frame's longer side."""
    out = {}
    for name, (h, w) in image_shapes.items():
        side = max(w * (1 - 2 * margin), h * (1 - 2 * margin))
        out[name] = np.array([[w / 2.0, h / 2.0, side, side]], np.float32)
    return out


def bbox_to_center_scale(bboxes: np.ndarray, scale_factor: float = 1.0):
    """[cx, cy, w, h] -> (center (N, 2), scale (N,)) float32 with the SPIN
    convention scale = max_side * scale_factor / 200."""
    center = bboxes[:, :2].astype(np.float32)
    scale = (np.maximum(bboxes[:, 2], bboxes[:, 3])
             * scale_factor / 200.0).astype(np.float32)
    return center, scale
