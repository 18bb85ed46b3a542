"""The export, the loaded artifact and spec_synth's SMPL on a card: K1's
custom op on CUDA tensors (opcheck), an artifact exported on the CPU and
one exported on the card, each loaded on the card and held to the CPU's
live predictor, and spec_synth's SMPL on the card held to the CPU's.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_export.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch import export as EX
from spec_tpu_torch.ops import lbs as L

# card vs CPU, fp32 (chip_smoke.py's PREDICT_LIMITS['fp32'])
LIMITS = dict(pred_pose=2e-3, pred_pose_6d=2e-3, pred_shape=2e-3,
              pred_cam=2e-3, pred_cam_t=2e-3, smpl_vertices=5e-3,
              smpl_joints3d=5e-3, smpl_joints2d=0.1)
ANGLE_LIMIT = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


def _frames_boxes():
    rng = np.random.RandomState(11)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)
              for _ in range(3)]
    boxes = [np.zeros((0, 4), np.float32),
             np.array([[40.0, 55.0, 50.0, 50.0]], np.float32),
             np.array([[60.0, 50.0, 40.0, 70.0], [90.0, 40.0, 30.0, 55.0],
                       [120.0, 10.0, 45.0, 60.0]], np.float32)]
    return frames, boxes


@pytest.mark.cuda
def test_fused_lbs_op_opcheck_on_the_card(cuda_device):
    from spec_tpu_torch.core import smpl as S

    packed = L.pack_lbs_operands(S.create_test_assets(
        num_vertices=333)).to(cuda_device)
    rng = np.random.RandomState(0)
    coeffs = torch.from_numpy(rng.randn(2, 218).astype('f4')).to(
        cuda_device).requires_grad_(True)
    rel_tf = torch.from_numpy(rng.randn(2, 24, 3, 4).astype('f4')).to(
        cuda_device).requires_grad_(True)
    result = torch.library.opcheck(
        torch.ops.spec_tpu_torch.fused_lbs.default,
        (packed.dirs, packed.weights_t, coeffs, rel_tf,
         packed.num_vertices))
    assert set(result.values()) == {'SUCCESS'}, result


@pytest.mark.cuda
@pytest.mark.parametrize('exported_on', ['cpu', 'cuda'])
def test_artifact_loaded_on_the_card_matches_the_cpu(cuda_device,
                                                     exported_on,
                                                     tmp_path,
                                                     monkeypatch):
    """ResNet-18 at min_size 96: the artifact (exported on the CPU or on
    the card) loaded on the card, its stages replaying CUDA graphs,
    against the CPU's live predictor; K1 launches on the card."""
    from spec_tpu_torch.serving import SpecPredictor

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path / 'no_assets'))
    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              use_cam_feats=True, min_size=96, batch_size=8)
    cpu = SpecPredictor(device='cpu', **kw)
    exporter = cpu if exported_on == 'cpu' else SpecPredictor(
        device=cuda_device, **kw)
    path = str(tmp_path / 'model.specx')
    EX.export_predictor(exporter, path)
    pred = EX.load_predictor(path, device=cuda_device)
    frames, boxes = _frames_boxes()
    pred.predict(frames, boxes)                     # captures
    before = L.LAUNCHES
    res, cams = pred.predict(frames, boxes, return_cameras=True)
    assert L.LAUNCHES - before == 1                 # one stage-2 chunk
    want, want_cams = cpu.predict(frames, boxes, return_cameras=True)
    for c, w in zip(cams, want_cams):
        for k in ('vfov', 'pitch', 'roll'):
            assert abs(c[k] - w[k]) <= ANGLE_LIMIT, k
    assert [len(r) for r in res] == [0, 1, 3]
    # a batch of one in both stages
    one = pred.predict(frames[1:2], boxes[1:2])
    assert len(one[0]) == 1
    for rg, rw in ((res, want), (one, want[1:2])):
        for fg, fw in zip(rg, rw):
            for pg, pw in zip(fg, fw):
                for k, lim in LIMITS.items():
                    assert np.abs(pg[k] - pw[k]).max() <= lim, k


@pytest.mark.cuda
def test_spec_synth_smpl_on_the_card_matches_the_cpu(cuda_device,
                                                     tmp_path):
    """One K1 launch over the whole set; the labels within the smoke's
    limits of the CPU's."""
    from spec_tpu_torch.datagen import spec_synth

    kw = dict(dataset='spec-syn', n=8, seed=1, hw=(96, 128), f_pix=160.0,
              writer=lambda img, path, q: None)
    before = L.LAUNCHES
    got = np.load(spec_synth.render_spec_synth_dataset(
        str(tmp_path / 'card'), device=cuda_device, **kw))
    assert L.LAUNCHES - before == 1
    want = np.load(spec_synth.render_spec_synth_dataset(
        str(tmp_path / 'cpu'), device='cpu', **kw))
    limits = dict(S=1e-5, part=5e-3, openpose=5e-3, center=5e-3,
                  scale=1e-4)
    for k in want:
        if k in limits:
            assert np.abs(got[k] - want[k]).max() <= limits[k], k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
