"""The port's host helpers of the CLIs against spec_tpu's, on the CPU:
image folder, detection files, CamCalib pickles, drawing, tracking,
smoothing (and its golden), SPEC config yamls and the reference flag
group.

Tolerances: exact where both sides run the same numpy/PIL/cv2 code
(pixels, boxes, track ids); 1e-6 where a normalization is computed by a
different but equivalent formula; smoothing within 1e-5 (rotation
conversions in torch instead of jnp, float32); the smoothing golden at
tests/test_goldens.py's ``RTOL, ATOL = 2e-3, 1e-5``.
"""

import glob
import json
import os

import cv2
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from spec_tpu.data import detection as JD
from spec_tpu.data import image_folder as JIF
from spec_tpu.data import tracking as JT
from spec_tpu.utils import cam_params as JCP
from spec_tpu.utils import smoothing as JSM
from spec_tpu.utils import vis as JV
from spec_tpu_torch.data import detection as TD
from spec_tpu_torch.data import image_folder as TIF
from spec_tpu_torch.data import tracking as TT
from spec_tpu_torch.utils import cam_params as TCP
from spec_tpu_torch.utils import smoothing as TSM
from spec_tpu_torch.utils import vis as TV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def image_dir(tmp_path, rng):
    d = tmp_path / 'imgs'
    d.mkdir()
    for i, (h, w) in enumerate([(48, 64), (64, 48), (48, 64), (30, 70)]):
        ext = 'png' if i % 2 else 'jpg'
        cv2.imwrite(str(d / f'im{i}.{ext}'),
                    (rng.rand(h, w, 3) * 255).astype('u1'))
    (d / '.hidden.png').write_bytes(b'')
    (d / 'notes.txt').write_text('x')
    return str(d)


def test_image_folder_matches(image_dir):
    names = TIF.list_images(image_dir)
    assert names == JIF.list_images(image_dir) and len(names) == 4
    port, ref = TIF.ImageFolder(names, 40), JIF.ImageFolder(names, 40)
    assert port.shape_buckets() == ref.shape_buckets()
    for i in range(len(names)):
        p, r = port[i], ref[i]
        assert p['imgname'] == r['imgname']
        np.testing.assert_array_equal(p['orig_shape'], r['orig_shape'])
        # The same PIL resize; normalization by an equivalent formula.
        np.testing.assert_allclose(p['img'], r['img'], atol=1e-6)
        u8, orig = port.load_u8(i)
        assert u8.dtype == np.uint8 and u8.shape == r['img'].shape
        np.testing.assert_array_equal(orig, r['orig_shape'])
    raw = TIF.ImageFolder(names, 40, normalize=False)[1]['img']
    np.testing.assert_allclose(
        raw, JIF.ImageFolder(names, 40, normalize=False)[1]['img'], atol=0)


@pytest.mark.parametrize('fmt', ['json', 'npz'])
def test_load_bboxes_file_matches(tmp_path, rng, fmt):
    dets = {'a.jpg': rng.rand(3, 4).astype('f4') * 100,
            'b.png': np.zeros((0, 4), 'f4'),
            '000001.png': rng.rand(1, 4).astype('f4') * 50}
    path = str(tmp_path / f'dets.{fmt}')
    if fmt == 'json':
        with open(path, 'w') as f:
            json.dump({k: v.tolist() for k, v in dets.items()}, f)
    else:
        np.savez(path, **dets)
    port, ref = TD.load_bboxes_file(path), JD.load_bboxes_file(path)
    assert sorted(port) == sorted(ref) == sorted(dets)
    for k in dets:
        assert port[k].dtype == np.float32
        np.testing.assert_array_equal(port[k], ref[k])


def test_full_image_bboxes_and_center_scale_match():
    shapes = {'a': (48, 64), 'b': (720, 1280), 'c': (100, 30)}
    port, ref = TD.full_image_bboxes(shapes), JD.full_image_bboxes(shapes)
    for k in shapes:
        np.testing.assert_array_equal(port[k], ref[k])
        for x, y in zip(TD.bbox_to_center_scale(port[k], 1.2),
                        JD.bbox_to_center_scale(ref[k], 1.2)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        TD.full_image_bboxes(shapes, margin=0.2)['b'],
        JD.full_image_bboxes(shapes, margin=0.2)['b'])


def test_read_cam_params_matches(tmp_path):
    pkl = str(tmp_path / 'x.jpg.pkl')
    joblib.dump({'vfov': np.float32(0.9), 'f_pix': np.float32(612.5),
                 'pitch': np.float32(-0.21), 'roll': np.float32(0.07)}, pkl)
    port = TCP.read_cam_params(pkl, 640.0, 480.0)
    ref = JCP.read_cam_params(pkl, 640.0, 480.0)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
    assert (TCP.cam_params_path('out', 'a/b/x.jpg')
            == JCP.cam_params_path('out', 'a/b/x.jpg'))


@pytest.mark.parametrize('case', ['horizon', 'horizon_no_text', 'gt_vs_pred',
                                  'skeleton'])
def test_drawing_matches(rng, case):
    img = (rng.rand(120, 160, 3) * 255).astype('u1')
    angles = (0.9, -0.15, 0.08)
    if case == 'horizon':
        port = TV.draw_horizon_line(img, *angles)
        ref = JV.draw_horizon_line(img, *angles)
    elif case == 'horizon_no_text':
        port = TV.draw_horizon_line(img.astype('f4'), *angles,
                                    debug_text=False, thickness=3)
        ref = JV.draw_horizon_line(img.astype('f4'), *angles,
                                   debug_text=False, thickness=3)
    elif case == 'gt_vs_pred':
        port = TV.gt_vs_pred_horizon(img, (1.0, 0.1, 0.0), angles)
        ref = JV.gt_vs_pred_horizon(img, (1.0, 0.1, 0.0), angles)
    else:
        kp = np.concatenate([rng.rand(49, 2) * 150,
                             (rng.rand(49, 1) > 0.3)], 1)
        port = TV.draw_skeleton(img, kp)
        ref = JV.draw_skeleton(img, kp)
    assert port.dtype == np.uint8 and not np.array_equal(port, img)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_allclose(TV.horizon_points(*angles, 160, 120),
                               JV.horizon_points(*angles, 160, 120), atol=0)


def _clip_boxes(rng, T=24):
    """Two persons crossing paths, one missed for three frames, and a
    third appearing late: [cx, cy, w, h] per frame."""
    frames = []
    for t in range(T):
        boxes = [[20 + 6 * t, 50, 30, 60], [170 - 6 * t, 52, 32, 58]]
        if 8 <= t < 11:
            boxes = boxes[:1]
        if t >= 15:
            boxes.append([90, 140 - t, 25, 50])
        frames.append(np.asarray(boxes, 'f4') + rng.randn(len(boxes), 4)
                      .astype('f4'))
    return frames


def test_iou_matrix_matches(rng):
    a, b = rng.rand(5, 4) * 50 + 10, rng.rand(3, 4) * 50 + 10
    np.testing.assert_array_equal(TT.iou_matrix(a, b), JT.iou_matrix(a, b))


@pytest.mark.parametrize('method', ['sort', 'iou'])
def test_trackers_match(rng, method):
    clip = _clip_boxes(rng)
    port = TT.track_video_boxes(clip, method=method)
    ref = JT.track_video_boxes(clip, method=method)
    assert [p.tolist() for p in port] == [r.tolist() for r in ref]
    assert len({int(i) for p in port for i in p}) >= 3


@pytest.mark.parametrize('t_idx', [None, np.array([0, 1, 2, 5, 6, 7, 9, 10])])
def test_one_euro_matches(rng, t_idx):
    xs = np.cumsum(rng.randn(8, 4, 6), 0).astype('f4')
    np.testing.assert_allclose(TSM.one_euro(xs, 30.0, t_idx=t_idx),
                               JSM.one_euro(xs, 30.0, t_idx=t_idx),
                               atol=0)
    with pytest.raises(ValueError):
        TSM.one_euro(xs, 30.0, t_idx=np.arange(8)[::-1])


def test_rotmat_to_rot6d_matches(rng):
    from spec_tpu.core import geometry as JG
    from spec_tpu_torch.core import geometry as TG

    R = np.array(JG.rodrigues(jnp.asarray(rng.randn(7, 3).astype('f4'))))
    r6 = TG.rotmat_to_rot6d(torch.from_numpy(R))
    np.testing.assert_array_equal(
        r6.numpy(), np.asarray(JG.rotmat_to_rot6d(jnp.asarray(R))))
    np.testing.assert_allclose(TG.rot6d_to_rotmat(r6).numpy(), R, atol=1e-6)


def test_smooth_track_params_matches(rng):
    from spec_tpu.core import geometry as JG

    T = 9
    pose = np.asarray(JG.rodrigues(jnp.asarray(
        rng.randn(T * 24, 3).astype('f4') * 0.4))).reshape(T, 24, 3, 3)
    betas = rng.randn(T, 10).astype('f4')
    cam = rng.randn(T, 3).astype('f4')
    frames = np.array([0, 1, 2, 3, 5, 6, 7, 8, 12])
    port = TSM.smooth_track_params(pose, betas, cam, 25.0, frames=frames,
                                   min_cutoff=0.01, beta=0.5)
    ref = JSM.smooth_track_params(pose, betas, cam, 25.0, frames=frames,
                                  min_cutoff=0.01, beta=0.5)
    assert set(port) == set(ref) == {'pose', 'betas', 'cam'}
    for k in ref:
        assert port[k].dtype == np.float32 and port[k].shape == ref[k].shape
        np.testing.assert_allclose(port[k], ref[k], atol=1e-5, err_msg=k)


def test_smoothing_golden():
    """tests/goldens.json's smoothing entry, computed with the port (the
    recipe of tests/test_goldens.py:compute_smoothing_golden)."""
    from spec_tpu.core import geometry as JG
    from tests.test_goldens import ATOL, GOLDENS_PATH, RTOL, _assert_close

    rng = np.random.RandomState(11)
    T = 8
    aa = rng.randn(T * 24, 3).astype('f4') * 0.4
    pose = np.asarray(JG.rodrigues(
        jnp.asarray(aa[:, None, :])))[:, 0].reshape(T, 24, 3, 3)
    betas = rng.randn(T, 10).astype('f4') * 0.3
    cam = rng.randn(T, 3).astype('f4')
    frames = np.array([0, 1, 2, 4, 5, 6, 8, 9])
    out = TSM.smooth_track_params(pose, betas, cam, fps=30.0, frames=frames)
    got = {
        'cam': [[float(v) for v in row] for row in out['cam']],
        'betas_row0': [float(v) for v in out['betas'][0]],
        'pose_trace': [float(np.trace(out['pose'][t].sum(0)))
                       for t in range(T)],
    }
    with open(GOLDENS_PATH) as f:
        golden = json.load(f)['smoothing']
    _assert_close(golden, got, 'smoothing', rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('cfg', sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, 'configs', '**', '*.yaml'),
                       recursive=True)))
def test_hmr_hparams_from_cfg_matches(cfg):
    from spec_tpu.utils.config import hmr_hparams_from_cfg as ref
    from spec_tpu_torch.utils.config import hmr_hparams_from_cfg as port

    path = os.path.join(ROOT, cfg)
    # the reference's (backbone, use_cam_feats), then the port's HMR.HEAD
    # (no shipped yaml names one: SPIN's regressor, the default)
    assert port(path) == (*ref(path), 'hmr')


def test_cfg_node_matches(tmp_path):
    """A yaml that sets the HMR keys, merged, overridden from a list and
    dumped: the same tree as the reference's CfgNode."""
    from spec_tpu.utils.config import CfgNode as JNode
    from spec_tpu_torch.utils import config as TC

    path = tmp_path / 'spec.yaml'
    path.write_text('HMR:\n  BACKBONE: resnet18\n  USE_CAM_FEATS: true\n'
                    'DATASET:\n  BATCH_SIZE: 8\n')
    assert TC.hmr_hparams_from_cfg(str(path)) == ('resnet18', True, 'hmr')
    port = TC.spec_default_config()
    port.merge_from_file(str(path))
    ref = JNode.from_dict(TC.spec_default_config().to_dict())
    ref.merge_from_file(str(path))
    opts = ['HMR.BACKBONE', 'resnet101', 'DATASET.BATCH_SIZE', '16']
    port.merge_from_list(opts)
    ref.merge_from_list(opts)
    assert port.to_dict() == ref.to_dict()
    assert port.DATASET.BATCH_SIZE == 16
    with pytest.raises(KeyError):
        port.merge_from_list(['HMR.NO_SUCH_KEY', '1'])
    port.dump(str(tmp_path / 'out.yaml'))
    back = TC.CfgNode()
    back.merge_from_file(str(tmp_path / 'out.yaml'))
    assert back.to_dict() == port.to_dict() == port.clone().to_dict()
