"""Temporal smoothing of per-track SMPL predictions for the video demo
(port of ``spec_tpu/utils/smoothing.py``).

A One-Euro filter (Casiez et al., CHI 2012) over each person track's
parameters, then one batched SMPL and full-image projection recompute on
the device (``cli/spec_demo._smooth_video_tracks``):

- the filter is a sequential scan over a track's frames, host numpy,
  vectorized over all coordinates of a track at once;
- rotations are smoothed in the continuous 6D representation
  (``rotmat_to_rot6d`` -> filter -> ``rot6d_to_rotmat``), which
  re-orthonormalizes by construction;
- betas are averaged over the track (a person's shape is constant).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spec_tpu_torch.core import geometry as G


def one_euro(xs: np.ndarray, fps: float, min_cutoff: float = 0.004,
             beta: float = 0.7, d_cutoff: float = 1.0,
             t_idx: np.ndarray = None) -> np.ndarray:
    """One-Euro filter over the leading (time) axis.

    Args:
      xs: (T, ...) signal sampled at ``fps``.
      min_cutoff: cutoff frequency floor (Hz) — lower = smoother at rest.
      beta: speed coefficient — higher = less lag during fast motion.
      d_cutoff: derivative low-pass cutoff (Hz).
      t_idx: optional (T,) strictly-increasing frame indices. Tracks can
        have GAPS (the IoU tracker bridges up to ``max_age`` missed
        frames): the elapsed time per step is then
        ``(t_idx[t] - t_idx[t-1]) / fps``, so the derivative estimate and
        the low-pass alphas stay correct across occlusions instead of
        treating the rejoin as one 1/fps step.
    Returns (T, ...) filtered signal (same dtype as float64 math, cast
    back to xs.dtype).
    """
    xs = np.asarray(xs)
    if xs.shape[0] <= 1:
        return xs.copy()
    if t_idx is None:
        dts = np.full(xs.shape[0] - 1, 1.0 / float(fps))
    else:
        t_idx = np.asarray(t_idx, np.float64)
        if t_idx.shape != (xs.shape[0],):
            raise ValueError(f't_idx shape {t_idx.shape} != (T,) = '
                             f'({xs.shape[0]},)')
        dts = np.diff(t_idx) / float(fps)
        if (dts <= 0).any():
            raise ValueError('t_idx must be strictly increasing')

    def alpha(cutoff, te):
        tau = 1.0 / (2.0 * np.pi * cutoff)
        return 1.0 / (1.0 + tau / te)

    out = np.empty_like(xs, dtype=np.float64)
    out[0] = xs[0]
    dx_prev = np.zeros_like(xs[0], dtype=np.float64)
    for t in range(1, xs.shape[0]):
        te = dts[t - 1]
        dx = (xs[t] - out[t - 1]) / te
        a_d = alpha(d_cutoff, te)
        dx_hat = a_d * dx + (1.0 - a_d) * dx_prev
        cutoff = min_cutoff + beta * np.abs(dx_hat)
        a = alpha(cutoff, te)
        out[t] = a * xs[t] + (1.0 - a) * out[t - 1]
        dx_prev = dx_hat
    return out.astype(xs.dtype)


def smooth_track_params(pose: np.ndarray, betas: np.ndarray,
                        cam: np.ndarray, fps: float,
                        min_cutoff: float = 0.004,
                        beta: float = 0.7,
                        frames: np.ndarray = None) -> Dict[str, np.ndarray]:
    """Smooth one track's SMPL parameters.

    Args:
      pose: (T, 24, 3, 3) predicted rotation matrices.
      betas: (T, 10).
      cam: (T, 3) crop weak-perspective (s, tx, ty).
      frames: optional (T,) frame indices of the track rows (tracks may
        skip occluded frames — see ``one_euro``'s ``t_idx``).
    Returns dict with smoothed ``pose`` (re-orthonormalized rotmats),
    ``betas`` (track mean, broadcast back to T), ``cam``.
    """
    T = pose.shape[0]
    r6 = G.rotmat_to_rot6d(torch.from_numpy(np.array(
        pose, np.float32))).numpy().reshape(T, 24, 6)
    r6s = one_euro(r6, fps, min_cutoff=min_cutoff, beta=beta,
                   t_idx=frames)
    pose_s = G.rot6d_to_rotmat(torch.from_numpy(
        np.ascontiguousarray(r6s))).numpy()
    betas_s = np.broadcast_to(betas.mean(axis=0, keepdims=True),
                              betas.shape).copy()
    cam_s = one_euro(np.asarray(cam), fps, min_cutoff=min_cutoff,
                     beta=beta, t_idx=frames)
    return {'pose': pose_s.astype(np.float32),
            'betas': betas_s.astype(np.float32),
            'cam': cam_s.astype(np.float32)}
