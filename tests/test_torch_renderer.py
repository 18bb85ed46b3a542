"""spec_tpu_torch.utils.renderer against spec_tpu.utils.renderer on the
CPU, and the port's demos drawing meshes.

* ``rasterize_mesh`` on the synthetic SMPL mesh (V = 6890 and its 13780
  faces; posed at several placements and image sizes) is bit-identical
  to the JAX package's native path, ``rgb`` and ``mask``: one source
  (``raster.cpp``), the same ``g++`` flags.
* The ground plane's convex fill equals ``cv2.fillConvexPoly`` pixel for
  pixel: the edge budget is N = 0 pixels per quad (``FILL_BUDGET``), on
  random convex polygons in and around the image and on the checkerboard
  quads of side views.
* ``render_overlay_image``, ``render_image_group``, ``render_tb_grid``
  and ``render_mesh_overlay`` on the inputs of tests/test_renderer.py
  (and on the SMPL mesh) equal the JAX package's bit for bit.
* ``spec_demo`` on a tiny folder writes overlays equal to the JAX demo's
  ``_render_overlay_img`` over the port's own results and cameras.

spec_tpu.native is built privately into a temporary directory (its
in-tree build races under xdist).
"""

import os
import types

import cv2
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.utils import renderer as JR
from spec_tpu_torch import native
from spec_tpu_torch.utils import renderer as TR

FILL_BUDGET = 0      # pixels per quad that may differ from cv2


@pytest.fixture(autouse=True, scope='module')
def jax_native(tmp_path_factory):
    """spec_tpu.native built into a private path for this module."""
    import spec_tpu.native as JN

    saved = JN._SO, JN._lib, JN._failed
    JN._SO = str(tmp_path_factory.mktemp('jax_native') / '_native.so')
    JN._lib, JN._failed = None, False
    assert JN.available()
    yield JN
    JN._SO, JN._lib, JN._failed = saved


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def smpl_mesh():
    a = JS.create_test_assets()
    faces = np.asarray(a.faces, np.int32)
    assert faces.shape == (13780, 3)
    return np.asarray(a.v_template, np.float32), faces


def make_quad(z, half=0.5, offset=(0.0, 0.0)):
    """tests/test_renderer.py's square at depth z, facing the camera."""
    ox, oy = offset
    verts = np.array([
        [-half + ox, -half + oy, z], [half + ox, -half + oy, z],
        [half + ox, half + oy, z], [-half + ox, half + oy, z]], np.float32)
    return verts, np.array([[0, 2, 1], [0, 3, 2]], np.int32)


K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)


@pytest.mark.parametrize('case', [
    dict(hw=(96, 128), t=(0.0, 0.0, 2.5), f=120.0),
    dict(hw=(240, 320), t=(0.2, -0.1, 3.0), f=400.0),
    dict(hw=(64, 48), t=(1.5, 0.0, 1.0), f=60.0),    # partly off-image
])
def test_rasterize_smpl_mesh_bit_identical(smpl_mesh, case, rng):
    verts, faces = smpl_mesh
    verts = verts + rng.randn(*verts.shape).astype(np.float32) * 0.005
    vc = verts + np.asarray(case['t'], np.float32)
    H, W = case['hw']
    Kc = np.array([[case['f'], 0, W / 2], [0, case['f'], H / 2], [0, 0, 1]],
                  np.float32)
    for color in ((0.7, 0.5, 0.5), (0.65, 0.74, 0.86)):
        rgb_t, mask_t = TR.rasterize_mesh(vc, faces, Kc, (H, W), color)
        rgb_j, mask_j = JR.rasterize_mesh(vc, faces, Kc, (H, W), color)
        assert mask_t.any()
        np.testing.assert_array_equal(mask_t, mask_j)
        np.testing.assert_array_equal(rgb_t, rgb_j)


def test_quad_geometry_and_occlusion():
    """tests/test_renderer.py's projection and z-order cases."""
    verts, faces = make_quad(z=2.0)
    rgb, mask = TR.rasterize_mesh(verts, faces, K, (128, 128))
    ys, xs = np.nonzero(mask)
    assert abs(xs.mean() - 64) < 2 and abs(ys.mean() - 64) < 2
    assert 38 < xs.min() < 40 and 88 < xs.max() < 90
    v2, f2 = make_quad(z=4.0, half=2.5)
    both_v, both_f = np.concatenate([verts, v2]), np.concatenate(
        [faces, f2 + 4])
    near, _ = TR.rasterize_mesh(verts, faces, K, (128, 128), (1, 0, 0))
    both, mask2 = TR.rasterize_mesh(both_v, both_f, K, (128, 128), (1, 0, 0))
    np.testing.assert_array_equal(both[64, 64], near[64, 64])
    assert mask2[64, 10] and not mask[64, 10]


def test_fill_matches_cv2_within_budget(rng):
    worst = 0
    for _ in range(400):
        H, W = rng.randint(8, 90), rng.randint(8, 90)
        s = 10 ** rng.uniform(0.5, 3.5)
        c = rng.uniform(-s, W + s), rng.uniform(-s, H + s)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 4))[::rng.choice([1, -1])]
        r = rng.uniform(0.5, s, 2)
        pts = np.stack([c[0] + r[0] * np.cos(ang), c[1] + r[1] * np.sin(ang)],
                       1).round().astype(np.int32)
        a = rng.rand(H, W, 3).astype(np.float32)
        b = a.copy()
        cv2.fillConvexPoly(a, pts, (0.85, 0.85, 0.85))
        native.fill_convex_poly(b, pts, (0.85, 0.85, 0.85))
        worst = max(worst, int((a != b).any(-1).sum()))
    assert worst <= FILL_BUDGET


@pytest.mark.parametrize('angle', [90, 180, 270])
def test_ground_plane_side_views_match_reference(smpl_mesh, angle):
    verts, faces = smpl_mesh
    img = np.zeros((120, 160, 3), np.float32)
    args = (np.array([0.1, 0.3, 4.0], np.float32), verts,
            np.eye(3, dtype=np.float32), (150.0, 150.0), (80.0, 60.0), faces)
    got = TR.render_overlay_image(img, *args, sideview_angle=angle,
                                  add_ground_plane=True)
    want = JR.render_overlay_image(img, *args, sideview_angle=angle,
                                   add_ground_plane=True)
    assert (got != 0).any()
    np.testing.assert_array_equal(got, want)


def test_overlay_composites_on_image(rng):
    verts, faces = make_quad(z=2.0)
    img = rng.rand(128, 128, 3).astype(np.float32)
    args = (img, np.zeros(3, np.float32), verts, np.eye(3, dtype=np.float32),
            (100.0, 100.0), (64.0, 64.0), faces)
    out = TR.render_overlay_image(*args)
    np.testing.assert_array_equal(out, JR.render_overlay_image(*args))
    changed = np.abs(out - img).sum(-1) > 1e-6
    assert changed[64, 64] and not changed[0, 0]


def test_render_image_group_matches_reference(rng, tmp_path):
    verts, faces = make_quad(z=2.0)
    img = rng.rand(96, 128, 3).astype(np.float32)
    kw = dict(cam_params=np.array([1.0, 0.05, 0.01, 100.0]),
              keypoints_2d=np.array([[30.0, 40.0, 1.0], [60, 50, 0]]))
    args = (img, np.zeros(3, np.float32), verts, np.eye(3, dtype=np.float32),
            (100.0, 100.0), (64.0, 48.0), faces)
    got = TR.render_image_group(*args, save_filename=str(tmp_path / 't.jpg'),
                                **kw)
    want = JR.render_image_group(*args, save_filename=str(tmp_path / 'j.jpg'),
                                 **kw)
    assert got.shape == (96, 128 * 3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 't.jpg')),
                                  cv2.imread(str(tmp_path / 'j.jpg')))


def test_render_tb_grid_matches_reference(rng):
    N = 3
    verts, faces = make_quad(z=2.0)
    images = rng.rand(N, 64, 96, 3).astype(np.float32)
    kw = dict(vertices=np.stack([verts] * N),
              camera_translation=np.zeros((N, 3), np.float32),
              camera_rotation=np.stack([np.eye(3, dtype=np.float32)] * N),
              focal_length=np.full((N, 2), 100.0, np.float32),
              camera_center=np.tile(np.array([48.0, 32.0], np.float32),
                                    (N, 1)),
              faces=faces, sideview_angles=(90, 270), max_samples=2,
              keypoints_2d=rng.rand(N, 5, 2) * 60)
    got = TR.render_tb_grid(images, **kw)
    assert got.shape == (2 * 64, 4 * 96, 3)
    np.testing.assert_array_equal(got, JR.render_tb_grid(images, **kw))
    assert got[:64, 192:288].sum() > 0


def test_render_mesh_overlay_matches_reference(smpl_mesh, rng):
    verts, faces = smpl_mesh
    img = (rng.rand(90, 160, 3) * 255).astype(np.uint8)
    vb = np.stack([verts, verts + 0.2])
    tb = np.array([[0.3, 0.1, 4.0], [-0.4, 0.0, 5.0]], np.float32)
    got = TR.render_mesh_overlay(img, vb, tb, faces, 200.0, pitch=0.1,
                                 roll=-0.05)
    want = JR.render_mesh_overlay(img, vb, tb, faces, 200.0, pitch=0.1,
                                  roll=-0.05)
    assert got.dtype == np.uint8 and (got != img).any()
    np.testing.assert_array_equal(got, want)


def test_raster_binding_refuses_bad_arrays(smpl_mesh):
    verts, faces = smpl_mesh
    light = TR._LIGHT_DIRS
    color = np.array([0.7, 0.5, 0.5], np.float32)
    with pytest.raises(TypeError, match='faces'):
        native.raster_mesh(verts, faces.astype(np.int64), K, (8, 8), color,
                           light)
    with pytest.raises(ValueError, match='verts_cam'):
        native.raster_mesh(verts[:, :2].copy(), faces, K, (8, 8), color,
                           light)
    with pytest.raises(ValueError, match='C-contiguous'):
        native.raster_mesh(np.asfortranarray(verts), faces, K, (8, 8),
                           color, light)


def test_spec_demo_overlays_match_reference_render(tmp_path, rng):
    """The port's folder demo (ResNet-18, random init, two boxes) writes
    overlays equal to the JAX demo's ``_render_overlay_img`` over the
    same results, cameras and faces; the meshes cover pixels."""
    import joblib

    from spec_tpu.cli import spec_demo as JDemo
    from spec_tpu_torch.cli import spec_demo as TDemo

    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    img = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(img_dir / 'im0.png'), img)
    cfg = tmp_path / 'r18.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n  USE_CAM_FEATS: false\n')
    import json
    with open(tmp_path / 'dets.json', 'w') as f:
        json.dump({'im0.png': [[60, 50, 40, 70], [100, 40, 30, 50]]}, f)
    out = tmp_path / 'out'
    TDemo.main(['--image_folder', str(img_dir), '--output_folder', str(out),
                '--spec_ckpt', str(tmp_path / 'none.pt'), '--cfg', str(cfg),
                '--bbox_file', str(tmp_path / 'dets.json'),
                '--min_size', '64', '--batch_size', '2', '--device', 'cpu'])
    merged = joblib.load(out / 'spec_results' / 'im0.pkl')
    cam = joblib.load(out / 'camcalib' / 'im0.png.pkl')
    faces = JS.create_test_assets().faces
    rgb = cv2.cvtColor(cv2.imread(str(img_dir / 'im0.png')),
                       cv2.COLOR_BGR2RGB)
    want = JDemo._render_overlay_img(rgb, merged, cam,
                                     types.SimpleNamespace(faces=faces))
    got = cv2.cvtColor(cv2.imread(str(out / 'spec_images' / 'im0.png')),
                       cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got, want)
    no_mesh = JDemo._render_overlay_img(
        rgb, dict(merged, smpl_vertices=merged['smpl_vertices'][:0]), cam,
        types.SimpleNamespace(faces=faces))
    assert (got != no_mesh).any(-1).sum() > 50
    assert os.path.getsize(out / 'spec_images' / 'im0.png') > 0
