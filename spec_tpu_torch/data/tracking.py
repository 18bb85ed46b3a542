"""Multi-person box tracking for the video demo (port of
``spec_tpu/data/tracking.py``; numpy only, on the host: tracking is
bookkeeping, not device work).

Two trackers:

- :class:`SortTracker` — the default: SORT as in the MPT package
  (Kalman constant-velocity motion model over [cx, cy, area, aspect],
  Hungarian assignment on IoU). The motion model carries identities
  through missed detections and crossing paths, which greedy
  last-box IoU cannot.
- :class:`IoUTracker` — greedy best-first IoU on the last seen box;
  simpler, no scipy needed (SORT's Hungarian step is scipy's
  ``linear_sum_assignment``); the automatic fallback when scipy is
  absent. Both are strictly causal (no lookahead).

Webcam mode predicts per frame without a tracker
(``cli/spec_demo.py`` ``run_spec_webcam``).
"""

from __future__ import annotations

import importlib.util
import warnings
from typing import Dict, List

import numpy as np


def _cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float32).reshape(-1, 4)
    half = b[:, 2:4] / 2.0
    return np.concatenate([b[:, :2] - half, b[:, :2] + half], axis=1)


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of two (N, 4) / (M, 4) [cx, cy, w, h] box sets."""
    a = _cxcywh_to_xyxy(boxes_a)[:, None]      # (N, 1, 4)
    b = _cxcywh_to_xyxy(boxes_b)[None]         # (1, M, 4)
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


class IoUTracker:
    """Greedy best-first IoU association with a max-age grace period.

    ``update(boxes)`` is called once per frame with (N, 4) [cx, cy, w, h]
    boxes and returns an (N,) int array of stable track ids. A detection
    matches the live track with the highest IoU above ``iou_threshold``
    (each track used once per frame, best pairs first); unmatched
    detections open new tracks; tracks unseen for more than ``max_age``
    frames are retired.
    """

    def __init__(self, iou_threshold: float = 0.3, max_age: int = 5):
        self.iou_threshold = iou_threshold
        self.max_age = max_age
        self._tracks: Dict[int, dict] = {}   # id -> {box, last_seen}
        self._next_id = 0
        self._frame = -1

    def update(self, boxes: np.ndarray) -> np.ndarray:
        self._frame += 1
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        # Retire stale tracks.
        self._tracks = {
            tid: t for tid, t in self._tracks.items()
            if self._frame - t['last_seen'] <= self.max_age}

        ids = np.full(len(boxes), -1, np.int64)
        if len(boxes) and self._tracks:
            tids = list(self._tracks)
            m = iou_matrix(
                boxes, np.stack([self._tracks[t]['box'] for t in tids]))
            # Greedy best-first assignment.
            while True:
                i, j = np.unravel_index(np.argmax(m), m.shape)
                if m[i, j] < self.iou_threshold:
                    break
                ids[i] = tids[j]
                m[i, :] = -1.0
                m[:, j] = -1.0
        for i in range(len(boxes)):
            if ids[i] < 0:
                ids[i] = self._next_id
                self._next_id += 1
            self._tracks[int(ids[i])] = {
                'box': boxes[i], 'last_seen': self._frame}
        return ids


class _KalmanBox:
    """Constant-velocity Kalman filter over z = [cx, cy, s, r]
    (s = area, r = aspect, r has no velocity) — the SORT paper's
    formulation, with its standard noise magnitudes."""

    _F = np.eye(7, dtype=np.float64)
    _F[0, 4] = _F[1, 5] = _F[2, 6] = 1.0
    _H = np.eye(4, 7, dtype=np.float64)
    _Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])
    _R = np.diag([1.0, 1.0, 10.0, 10.0])

    def __init__(self, box: np.ndarray):
        self.x = np.zeros(7, np.float64)
        self.x[:4] = self._to_z(box)
        self.P = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])

    @staticmethod
    def _to_z(box):
        cx, cy, w, h = np.asarray(box, np.float64)
        return np.array([cx, cy, w * h, w / max(h, 1e-9)])

    @staticmethod
    def _to_box(z):
        cx, cy, s, r = z
        s, r = max(float(s), 1e-9), max(float(r), 1e-9)
        w = np.sqrt(s * r)
        return np.array([cx, cy, w, s / w], np.float32)

    def predict(self) -> np.ndarray:
        # A shrinking box can drive the area velocity negative past
        # zero; freeze the area velocity instead of predicting an
        # impossible box (SORT does the same).
        if self.x[2] + self.x[6] <= 0:
            self.x[6] = 0.0
        self.x = self._F @ self.x
        self.P = self._F @ self.P @ self._F.T + self._Q
        return self._to_box(self.x[:4])

    def update(self, box: np.ndarray):
        z = self._to_z(box)
        y = z - self._H @ self.x
        S = self._H @ self.P @ self._H.T + self._R
        K = self.P @ self._H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(7) - K @ self._H) @ self.P


class SortTracker:
    """SORT: Kalman-predicted boxes + Hungarian IoU assignment.

    Same contract as :class:`IoUTracker`: ``update(boxes)`` per frame
    with (N, 4) [cx, cy, w, h], returns (N,) stable track ids (every
    detection gets an id; unmatched ones open new tracks).
    """

    def __init__(self, iou_threshold: float = 0.3, max_age: int = 5):
        self.iou_threshold = iou_threshold
        self.max_age = max_age
        self._tracks: Dict[int, dict] = {}   # id -> {kf, last_seen}
        self._next_id = 0
        self._frame = -1

    def update(self, boxes: np.ndarray) -> np.ndarray:
        from scipy.optimize import linear_sum_assignment

        self._frame += 1
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        self._tracks = {
            tid: t for tid, t in self._tracks.items()
            if self._frame - t['last_seen'] <= self.max_age}

        tids = list(self._tracks)
        preds = [self._tracks[t]['kf'].predict() for t in tids]
        ids = np.full(len(boxes), -1, np.int64)
        if len(boxes) and tids:
            m = iou_matrix(boxes, np.stack(preds))
            rows, cols = linear_sum_assignment(-m)
            for i, j in zip(rows, cols):
                if m[i, j] >= self.iou_threshold:
                    ids[i] = tids[j]
                    self._tracks[tids[j]]['kf'].update(boxes[i])
                    self._tracks[tids[j]]['last_seen'] = self._frame
        for i in range(len(boxes)):
            if ids[i] < 0:
                ids[i] = self._next_id
                self._next_id += 1
                self._tracks[int(ids[i])] = {
                    'kf': _KalmanBox(boxes[i]), 'last_seen': self._frame}
        return ids


def track_video_boxes(per_frame_boxes: List[np.ndarray],
                      iou_threshold: float = 0.3,
                      max_age: int = 5,
                      method: str = 'sort') -> List[np.ndarray]:
    """Convenience: run a tracker over a whole clip.
    Returns per-frame (N_i,) track-id arrays. ``method`` is 'sort'
    (reference-equivalent, default) or 'iou' (greedy last-box IoU).
    Without scipy, 'sort' degrades to 'iou' with a warning instead of
    crashing after the (potentially long) model pass that produced the
    boxes."""
    if method == 'sort' and importlib.util.find_spec('scipy') is None:
        warnings.warn('scipy is not installed; SORT needs '
                      'scipy.optimize.linear_sum_assignment — falling '
                      'back to the greedy IoU tracker (--tracker iou)')
        method = 'iou'
    cls = {'sort': SortTracker, 'iou': IoUTracker}[method]
    tracker = cls(iou_threshold=iou_threshold, max_age=max_age)
    return [tracker.update(b) for b in per_frame_boxes]
