"""Person boxes for the demos and the server (the host part of
``spec_tpu/data/detection.py``).

Boxes are ``[cx, cy, w, h]`` in pixels. They come from the in-process
YOLOv3 (:func:`run_yolo_detections`, :mod:`spec_tpu_torch.models.detector`),
a precomputed file (:func:`load_bboxes_file`) or one whole-image box per
frame (:func:`full_image_bboxes`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

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


# One detector (weights loaded, graphs captured) per configuration: the
# chunked video demo calls run_yolo_detections once per chunk.
_YOLO_CACHE: Dict[tuple, object] = {}


def run_yolo_detections(image_paths: List[str], weights_path: str,
                        img_size: int = 416, batch_size: int = 8,
                        conf_thresh: float = 0.7,
                        device='cuda') -> Dict[str, np.ndarray]:
    """The in-process YOLOv3 over image files (read with PIL) ->
    {basename: (N, 4) square [cx, cy, w, h] person boxes}. ``conf_thresh``
    is host-only, so it is not part of the detector's cache key."""
    from PIL import Image

    from spec_tpu_torch.models.detector import YoloDetector

    key = (weights_path, img_size, batch_size, str(device))
    if key not in _YOLO_CACHE:
        _YOLO_CACHE[key] = YoloDetector(
            weights_path=weights_path or None, img_size=img_size,
            batch_size=batch_size, device=device)
    det = _YOLO_CACHE[key]
    out: Dict[str, np.ndarray] = {}
    for start in range(0, len(image_paths), 64):   # bounds host memory
        chunk = image_paths[start:start + 64]
        frames = []
        for p in chunk:
            with Image.open(p) as im:
                frames.append(np.asarray(im.convert('RGB')))
        for p, boxes in zip(chunk,
                            det.detect(frames, conf_thresh=conf_thresh)):
            out[os.path.basename(p)] = boxes
    return out


def bbox_to_center_scale(bboxes: np.ndarray, scale_factor: float = 1.0):
    """[cx, cy, w, h] -> (center (N, 2), scale (N,)) float32 with the SPIN
    convention scale = max_side * scale_factor / 200."""
    center = bboxes[:, :2].astype(np.float32)
    scale = (np.maximum(bboxes[:, 2], bboxes[:, 3])
             * scale_factor / 200.0).astype(np.float32)
    return center, scale
