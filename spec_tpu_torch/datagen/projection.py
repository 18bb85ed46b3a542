"""Equirectangular -> perspective (gnomonic) projection (port of
``spec_tpu/datagen/projection.py``; host numpy, cv2 imported where the
crop is cut).

The geometry behind both of the reference's Pano360 crop generators
(``camcalib/pano_preprocessing.py:329-355`` via the ``envmap`` package and
``camcalib/datagen/image_extraction.py:28-161``, ScaleNet-derived):

For each pixel of the target perspective image, build the camera ray
through the pinhole with the sampled (vfov, pitch, roll, yaw), convert the
rotated ray to spherical (lat, lon), and bilinearly sample the
equirectangular panorama at (lon / 2pi, lat / pi). Implemented as a
closed-form coordinate grid + one ``cv2.remap`` (SIMD C path); the grid
math is pure numpy and unit-tested against known directions.
"""

from __future__ import annotations

import numpy as np


def camera_rays(out_h: int, out_w: int, vfov: float) -> np.ndarray:
    """Unit rays through each target pixel for a pinhole camera looking
    down +Z (x right, y down), vertical fov ``vfov`` (radians)."""
    f = (out_h / 2.0) / np.tan(vfov / 2.0)
    ys, xs = np.meshgrid(
        np.arange(out_h, dtype=np.float64) + 0.5 - out_h / 2.0,
        np.arange(out_w, dtype=np.float64) + 0.5 - out_w / 2.0,
        indexing='ij')
    rays = np.stack([xs / f, ys / f, np.ones_like(xs)], axis=-1)
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


def rotation_from_angles(pitch: float, roll: float, yaw: float) -> np.ndarray:
    """World-from-camera rotation consistent with the framework's camera
    convention: camera-from-world is ``Rx(pitch) @ Rz(roll)`` (PARE
    ``batch_euler2matrix([pitch, 0, roll])``, geometry.euler_to_rotmat),
    under which positive pitch places the horizon ABOVE the image center
    (matching the horizon-line vis ``ctr = 0.5 - 0.5 tan(pitch)/tan(vfov/2)``
    and the reference's annotation convention). Datagen renders with the
    TRANSPOSE (world-from-camera), plus a yaw pan about the pano's Y.

    Regression note: an earlier version used ``Rx(+pitch)`` here, which
    MIRRORED the horizon in generated crops relative to the stored pitch
    annotation (pitch > 0 put the horizon below center while the vis and
    the camera math put it above)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return Ry @ (Rx @ Rz).T


def rays_to_equirect_uv(rays_world: np.ndarray, pano_w: int, pano_h: int):
    """Unit world rays -> pixel coordinates in the equirect pano.

    Convention: lon = atan2(x, z) in [-pi, pi] maps to u in [0, W);
    lat = asin(-y) in [-pi/2, pi/2] maps to v in [0, H) with v=0 at the
    zenith (y points down in camera coords)."""
    x, y, z = rays_world[..., 0], rays_world[..., 1], rays_world[..., 2]
    lon = np.arctan2(x, z)
    lat = np.arcsin(np.clip(-y, -1.0, 1.0))
    u = (lon / (2 * np.pi) + 0.5) * pano_w - 0.5
    v = (0.5 - lat / np.pi) * pano_h - 0.5
    return u.astype(np.float32), v.astype(np.float32)


def equirect_to_perspective(
    pano: np.ndarray,
    vfov: float,
    pitch: float,
    roll: float,
    yaw: float,
    out_hw: tuple,
) -> np.ndarray:
    """Extract one perspective crop from an equirect panorama.

    Positive pitch raises the horizon above the image center (the
    framework-wide camera convention — see rotation_from_angles);
    positive roll tilts the horizon; yaw pans.
    """
    import cv2

    out_h, out_w = out_hw
    rays = camera_rays(out_h, out_w, vfov)
    R = rotation_from_angles(pitch, roll, yaw)
    rays_world = rays @ R.T
    u, v = rays_to_equirect_uv(rays_world, pano.shape[1], pano.shape[0])
    return cv2.remap(
        pano, u, v, interpolation=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_WRAP)
