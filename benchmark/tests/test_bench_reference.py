"""The plain reference agrees with the program at a small size on the
CPU, piece by piece: the networks under one state dict, SMPL and the
camera head, the resize, the crop, the bin decode and the keyframe
rule."""

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark import weights as W
from benchmark.reference import geometry as G
from benchmark.reference import image, nets
from benchmark.reference.smpl import cam_head

GAINS = {'fc_vfov': 1.0, 'fc_pitch': 1.0, 'fc_roll': 1.0, 'decpose': 0.2,
         'decshape': 0.5, 'deccam': 0.05}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(model, x, stream=4):
    init = {'batchnorm_gamma': 0.35, 'linear_gains': GAINS}
    return W.calibrated(model, W.network_state(model, 7, stream, init,
                                               'cpu'), x)


def _port_assets(a):
    from spec_tpu_torch.core import constants as C
    from spec_tpu_torch.core import smpl as S

    return S.with_packed_lbs(S.SMPLAssets(
        v_template=a['v_template'], shapedirs=a['shapedirs'],
        posedirs=a['posedirs'], j_regressor=a['j_regressor'],
        lbs_weights=a['lbs_weights'],
        parents=tuple(int(p) for p in C.SMPL_PARENTS),
        extra_vertex_ids=tuple(int(i) for i in C.EXTRA_VERTEX_JOINT_IDS),
        j_regressor_extra=a['j_regressor_extra']))


def test_camcalib_matches_the_port():
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork

    x = torch.rand(2, 3, 64, 96) * 4 - 2
    ref = nets.CamCalib('resnet18')
    state = _state(ref, x)
    port = CameraRegressorNetwork('resnet18')
    port.load_state_dict(state)
    port.eval()
    with torch.no_grad():
        a = ref(x)
        b = port(x.permute(0, 2, 3, 1))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('backbone', ['resnet18', 'hrnet_w32-conv'])
def test_hmr_and_the_smpl_head_match_the_port(backbone):
    from spec_tpu_torch.models.hmr import HMR

    torch.manual_seed(0)
    x = torch.rand(3, 3, 64, 64) * 4 - 2
    ref = nets.HMR(backbone)
    W.mean_params(ref)
    state = _state(ref, x, 5)
    port = HMR(backbone=backbone, use_cam=True, use_cam_feats=False,
               img_res=64)
    port.load_state_dict(state)
    port.eval()
    assets = W.smpl_assets(3, 6890, 'cpu')
    pitch, roll = torch.tensor([0.1, -0.2, 0.3]), torch.tensor([0.0, 0.1,
                                                                -0.1])
    R = G.euler_to_rotmat(pitch, roll)
    f = torch.tensor([900.0, 1100.0, 1000.0])
    w, h = torch.tensor([640.0, 1280.0, 800.0]), torch.tensor([480.0, 720.0,
                                                               600.0])
    K = torch.zeros(3, 3, 3)
    K[:, 0, 0] = K[:, 1, 1] = f
    K[:, 0, 2], K[:, 1, 2] = w / 2, h / 2
    center = torch.tensor([[300.0, 200.0], [700.0, 400.0], [400.0, 300.0]])
    scale = torch.tensor([1.5, 2.0, 1.0])
    with torch.no_grad():
        r = ref(x)
        r.update(cam_head(assets, r, R, f, center, scale, w, h, 64))
        p = port(_port_assets(assets), x.permute(0, 2, 3, 1), R, K, scale,
                 center, w, h)
    for k in ('pred_pose', 'pred_shape', 'pred_cam', 'pred_cam_t',
              'smpl_vertices', 'smpl_joints3d'):
        torch.testing.assert_close(r[k], p[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(r['smpl_joints2d'], p['smpl_joints2d'],
                               rtol=1e-4, atol=1e-3)
    # the random network is not degenerate: it moves the pose and shape
    assert r['pred_shape'].abs().max() > 0.1
    assert (r['pred_pose'] - torch.eye(3)).abs().max() > 0.05


def test_resize_crop_and_decode_match_the_port():
    from spec_tpu_torch.core import bins
    from spec_tpu_torch.ops import preprocess as P

    frame = traffic.scene(np.random.default_rng(1), 96, 128, 1)[0]
    t = torch.from_numpy(frame)
    for size in (64, 80, 96):
        assert torch.equal(image.resize_min_side(t, size),
                           P.resize_min_side(t, size))
    centers = np.array([[20.0, 30.0], [64.0, 48.0], [120.0, 90.0]],
                       np.float32)
    scales = np.array([0.3, 0.55, 0.21], np.float32)
    corners = P.spin_crop_corners(centers, scales, 64)
    for k in range(3):
        assert image.spin_corners(centers[k], scales[k], 64) == tuple(
            corners[k])
    port = P.crop_resize_normalize(t[None].float().expand(3, -1, -1, -1),
                                   torch.from_numpy(corners), res=64)
    ref = torch.stack([image.crop(t.float(), tuple(c), 64) for c in corners])
    torch.testing.assert_close(image.normalize(ref / 255.0),
                               port.permute(0, 3, 1, 2), rtol=1e-5,
                               atol=1e-4)
    logits = torch.randn(3, 4, 256) * 2
    want = bins.convert_preds_to_angles(*logits)
    got = [image.softargmax_angle(logits[0], *image.VFOV_RANGE),
           image.softargmax_angle(logits[1], *image.PITCH_RANGE),
           image.softargmax_angle(logits[2], *image.ROLL_RANGE)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_keyframes_follow_the_programs_rule():
    from spec_tpu_torch.serving import KeyframeSelector, frame_signature

    r = np.random.default_rng(2)
    frames = (traffic.scene(r, 48, 64, 5) + traffic.scene(r, 48, 64, 7))
    for every in (1, 3, 8):
        sel = KeyframeSelector(every, 0.5)
        want = [i for i, f in enumerate(frames)
                if sel.is_keyframe(frame_signature(f))]
        want = sorted(set(want) | {0})
        assert image.keyframes(frames, 0, every, 0.5) == want
