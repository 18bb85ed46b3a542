"""Host mesh renderer (port of ``spec_tpu/utils/renderer.py``).

Camera-frame projection with the full-image intrinsics, back-face
culling, flat Lambertian shading with the reference's light rig, and a
z-buffer: ``csrc/raster.cpp`` (built with ``g++`` at first use; a failed
build raises). The JAX package's cv2 painter's-algorithm fallback is not
ported: it needs cv2, which the machine with the card lacks, and it
gives different pixels from the z-buffer where faces overlap. The ground
plane's checkerboard quads are filled by ``csrc/raster.cpp``'s
``fill_convex_poly``, the pixels of ``cv2.fillConvexPoly``, so the
overlays need no cv2; drawing 2D joints and the horizon
(``utils/vis.py``) and writing JPEGs do, imported inside the functions.

The meshes come from the model's SMPL on the device (K1); rendering
runs on the host, as the reference's does.

API: :func:`render_overlay_image` (optional checkerboard ground plane at
the mesh's lowest point, side view rotated about the mesh centroid),
:func:`render_image_group` (input | overlay | 270-degree side view: the
eval pass's ``save_images``), :func:`render_tb_grid` (the trainer's
TensorBoard grid) and :func:`render_mesh_overlay` (the demos).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

MESH_COLORS = {
    'pinkish': (0.7, 0.5, 0.5),
    'blue': (0.65, 0.74, 0.86),
    'green': (0.5, 0.7, 0.5),
    'neutral': (0.7, 0.7, 0.6),
}

# The reference's light rig: one headlight and three offset directional
# lights.
_LIGHT_DIRS = np.array([
    [0.0, 0.0, 1.0],
    [0.0, -1.0, 1.0],
    [0.0, 1.0, 1.0],
    [1.0, 1.0, 2.0],
], np.float32)
_LIGHT_DIRS = _LIGHT_DIRS / np.linalg.norm(_LIGHT_DIRS, axis=1,
                                           keepdims=True)


def crop_intrinsics(K, center, scale, res: int):
    """Full-image intrinsics ``K`` (..., 3, 3) mapped into the
    box-centred SPIN crop of ``center`` (..., 2) and ``scale`` (...) at
    ``res`` pixels: crop_px = (orig_px - ul) * res / box, box = scale *
    200 (at least 1), ul = center - box / 2. Returns (focal_length
    (..., 2), camera_center (..., 2)), float64."""
    K = np.asarray(K, np.float64)
    box = np.maximum(np.asarray(scale, np.float64) * 200.0, 1.0)
    sc = (res / box)[..., None]
    ul = np.asarray(center, np.float64) - box[..., None] / 2.0
    focal = np.stack([K[..., 0, 0], K[..., 1, 1]], -1) * sc
    return focal, (K[..., :2, 2] - ul) * sc


def rasterize_mesh(
    verts_cam: np.ndarray,     # (V, 3) camera-frame vertices
    faces: np.ndarray,         # (F, 3)
    K: np.ndarray,             # (3, 3)
    image_hw: Tuple[int, int],
    base_color=(0.7, 0.5, 0.5),
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rgb float32 [0, 1] (H, W, 3), zero outside the mask; mask
    bool (H, W)): back-face culled, flat-shaded, z-buffered
    (``csrc/raster.cpp``)."""
    from spec_tpu_torch import native

    return native.raster_mesh(
        np.ascontiguousarray(verts_cam, np.float32),
        np.ascontiguousarray(faces, np.int32),
        np.ascontiguousarray(K, np.float32), image_hw,
        np.ascontiguousarray(base_color, np.float32), _LIGHT_DIRS)


def get_checkerboard_plane(plane_width=4.0, num_boxes=9):
    """Checkerboard quads in the XZ plane: a list of (4, 3) corners and
    their gray levels."""
    pw = plane_width / num_boxes
    quads, colors = [], []
    for i in range(num_boxes):
        for j in range(num_boxes):
            x0 = -plane_width / 2 + i * pw
            z0 = -plane_width / 2 + j * pw
            quads.append(np.array([
                [x0, 0, z0], [x0 + pw, 0, z0],
                [x0 + pw, 0, z0 + pw], [x0, 0, z0 + pw]], np.float32))
            c = 0.85 if (i + j) % 2 == 0 else 0.6
            colors.append((c, c, c))
    return quads, colors


def _rotate_about_centroid(verts, angle_deg):
    """``verts`` rotated by ``angle_deg`` about the vertical (y) axis
    through their centroid."""
    t = np.radians(angle_deg)
    c, s = np.cos(t), np.sin(t)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    ctr = verts.mean(0, keepdims=True)
    return (verts - ctr) @ R.T + ctr


def render_overlay_image(
    image: np.ndarray,          # float [0, 1] (H, W, 3)
    camera_translation: np.ndarray,
    vertices: np.ndarray,       # (V, 3) body frame
    camera_rotation: np.ndarray,
    focal_length: Tuple[float, float],
    camera_center: Tuple[float, float],
    faces: np.ndarray,
    mesh_color: str = 'pinkish',
    sideview_angle: float = 0,
    add_ground_plane: bool = False,
) -> np.ndarray:
    """The mesh composited over ``image`` (a copy): camera-frame
    vertices ``vertices @ R.T + t``, pinhole K from ``focal_length`` and
    ``camera_center``; with ``add_ground_plane`` a checkerboard at the
    body's lowest point is drawn first (quads with a vertex at z <=
    1e-3 are skipped)."""
    from spec_tpu_torch import native

    H, W = image.shape[:2]
    K = np.array([[focal_length[0], 0, camera_center[0]],
                  [0, focal_length[1], camera_center[1]],
                  [0, 0, 1]], np.float32)
    R = np.asarray(camera_rotation, np.float32)
    t = np.asarray(camera_translation, np.float32)[None]
    verts = np.asarray(vertices, np.float32)
    if sideview_angle:
        verts = _rotate_about_centroid(verts, sideview_angle)
    verts_cam = verts @ R.T + t

    color = MESH_COLORS.get(mesh_color, MESH_COLORS['pinkish'])
    out = np.array(image, np.float32, order='C')

    if add_ground_plane:
        y0 = verts[:, 1].min()
        quads, qcolors = get_checkerboard_plane()
        for quad, qc in zip(quads, qcolors):
            q = quad.copy()
            q[:, 1] += y0
            q_cam = q @ R.T + t
            if (q_cam[:, 2] <= 1e-3).any():
                continue
            proj = q_cam @ K.T
            pix = (proj[:, :2] / proj[:, 2:3]).round().astype(np.int32)
            native.fill_convex_poly(out, pix, qc)

    rgb, mask = rasterize_mesh(verts_cam, faces, K, (H, W),
                               base_color=color)
    out[mask] = rgb[mask]
    return out


def render_image_group(
    image: np.ndarray,
    camera_translation,
    vertices,
    camera_rotation,
    focal_length: Tuple[float, float],
    camera_center: Tuple[float, float],
    faces: np.ndarray,
    mesh_color: str = 'pinkish',
    save_filename: Optional[str] = None,
    keypoints_2d: Optional[np.ndarray] = None,
    cam_params: Optional[np.ndarray] = None,
) -> np.ndarray:
    """input | overlay | 270-degree side view with the ground plane,
    side by side (float32 [0, 1]); written as a JPEG to
    ``save_filename`` when given (cv2). ``keypoints_2d`` and
    ``cam_params`` (vfov, pitch, roll) draw the joints and the horizon
    on the input first (cv2)."""
    from spec_tpu_torch.utils.vis import draw_horizon_line, draw_skeleton

    if image.max() > 10:
        image = image.astype(np.float32) / 255.0
    image = image.astype(np.float32)

    if keypoints_2d is not None:
        image = draw_skeleton(
            (image * 255), keypoints_2d).astype(np.float32) / 255.0
    if cam_params is not None:
        image = draw_horizon_line(
            image * 255, cam_params[0], cam_params[1], cam_params[2],
            color=(0, 255, 0), debug_text=True).astype(np.float32) / 255.0

    overlay = render_overlay_image(
        image, camera_translation, vertices, camera_rotation,
        focal_length, camera_center, faces, mesh_color,
        sideview_angle=0, add_ground_plane=False)
    side = render_overlay_image(
        np.zeros_like(image), camera_translation, vertices,
        camera_rotation, focal_length, camera_center, faces, mesh_color,
        sideview_angle=270, add_ground_plane=True)

    out = np.concatenate([image, overlay, side], axis=1)
    if save_filename is not None:
        import cv2

        cv2.imwrite(save_filename, cv2.cvtColor(
            np.clip(out * 255, 0, 255).astype(np.uint8),
            cv2.COLOR_RGB2BGR))
    return out


def render_tb_grid(
    images: np.ndarray,              # (N, H, W, 3) float [0, 1] or [0, 255]
    vertices: np.ndarray,            # (N, V, 3)
    camera_translation: np.ndarray,  # (N, 3)
    camera_rotation: np.ndarray,     # (N, 3, 3)
    focal_length: np.ndarray,        # (N, 2)
    camera_center: np.ndarray,       # (N, 2)
    faces: np.ndarray,
    keypoints_2d: Optional[np.ndarray] = None,   # (N, K, 2) crop pixels
    sideview_angles: Tuple[float, ...] = (90, 180, 270),
    max_samples: int = 4,
    mesh_color: str = 'pinkish',
) -> np.ndarray:
    """The trainer's TensorBoard grid: one row per sample (at most
    ``max_samples``), ``[input (+ joints) | overlay | one side view per
    angle]``, rows stacked. Camera arguments are per sample (crop-frame
    intrinsics for crop inputs). Returns float32 [0, 1] of shape
    (rows * H, (2 + len(sideview_angles)) * W, 3)."""
    n = min(len(images), max_samples)
    rows = []
    for i in range(n):
        image = np.asarray(images[i], np.float32)
        if image.max() > 10:
            image = image / 255.0
        panel = image
        if keypoints_2d is not None:
            from spec_tpu_torch.utils.vis import draw_skeleton

            panel = draw_skeleton(
                (panel * 255), np.asarray(keypoints_2d[i])
            ).astype(np.float32) / 255.0
        fl = (float(focal_length[i][0]), float(focal_length[i][1]))
        cc = (float(camera_center[i][0]), float(camera_center[i][1]))
        cells = [panel, render_overlay_image(
            panel, camera_translation[i], vertices[i], camera_rotation[i],
            fl, cc, faces, mesh_color, sideview_angle=0,
            add_ground_plane=False)]
        for ang in sideview_angles:
            cells.append(render_overlay_image(
                np.zeros_like(image), camera_translation[i], vertices[i],
                camera_rotation[i], fl, cc, faces, mesh_color,
                sideview_angle=ang, add_ground_plane=True))
        rows.append(np.concatenate(cells, axis=1))
    return np.clip(np.concatenate(rows, axis=0), 0.0, 1.0)


def render_mesh_overlay(image_uint8, vertices_batch, cam_t_batch, faces,
                        focal_length, pitch=0.0, roll=0.0):
    """Every person's mesh over an RGB uint8 frame (the demos): camera
    rotation from CamCalib's (pitch, roll), principal point at the
    image center. Returns uint8 (H, W, 3)."""
    from spec_tpu_torch.core.geometry import euler_pitch_roll_np

    H, W = image_uint8.shape[:2]
    R = euler_pitch_roll_np(pitch, roll)
    out = image_uint8.astype(np.float32) / 255.0
    for verts, cam_t in zip(vertices_batch, cam_t_batch):
        out = render_overlay_image(
            out, cam_t, verts, R, (focal_length, focal_length),
            (W / 2.0, H / 2.0), faces)
    return np.clip(out * 255, 0, 255).astype(np.uint8)
