"""spec_tpu_torch's eval step and offline pass against spec_tpu's on the
CPU: ``make_eval_step`` (neutral and gendered GT with a mixed-gender
batch; ResNet-18, V = 128, B = 4, fp32, the JAX PRNGKey(0) weights
carried over by the bridge), ``compute_error`` for 3dpw-test-cam,
spec-syn and spec-mtp on N = 300 samples (two chunks of 256, the last
padded), the capturability of both graph bodies, the options that are
not ported yet, and ``evaluate_dataset(save_images=True)``: the
``val_images`` JPEG the port writes against the JAX package's (GT and
CamCalib cameras, the render_res display crop, the qualitative coco
pass), within ``RENDER_LEVELS``.

Limits: vertices within 1e-5 m (fp32 on both sides; the port's SMPL goes
through K1's plain version, the JAX step through plain LBS); metrics
within 0.05 mm (5e-5 m per sample, and on the mm headlines).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import constants as JC
from spec_tpu.core import smpl as JS
from spec_tpu.eval.eval_loop import make_eval_step as jax_make_eval_step
from spec_tpu.eval.evaluator import compute_error as jax_compute_error
from spec_tpu.models import HMR as JaxHMR
from spec_tpu_torch.eval import eval_loop as TL
from spec_tpu_torch.eval import evaluator as TE
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.utils.checkpoints import (
    assets_from_jax,
    state_dict_from_flax,
)

VERTS_M = 1e-5
# The val_images JPEGs, decoded: the meshes agree within VERTS_M, so a
# few edge pixels may flip; per 8-bit channel, the mean difference and
# the share of values more than 16 levels apart (read: identical files).
RENDER_LEVELS = dict(mean=0.5, far_share=2e-3)
METRIC_M = 5e-5      # 0.05 mm
METRIC_MM = 0.05
V, B, RES = 128, 4, 64


@pytest.fixture(scope='module')
def models():
    """The JAX HMR with PRNGKey(0) weights and the port's with the same
    weights; three asset sets (neutral, male, female)."""
    jassets = {g: JS.create_test_assets(num_vertices=V, seed=i)
               for i, g in enumerate(('neutral', 'male', 'female'))}
    jmodel = JaxHMR(backbone='resnet18', use_cam=True, use_cam_feats=True,
                    img_res=RES)
    eye = jnp.tile(jnp.eye(3), (1, 1, 1))
    variables = jmodel.init(
        jax.random.PRNGKey(0), jassets['neutral'],
        jnp.zeros((1, RES, RES, 3)), eye, eye, jnp.ones((1,)),
        jnp.ones((1, 2)), jnp.ones((1,)), jnp.ones((1,)))
    port = HMR(backbone='resnet18', use_cam_feats=True, img_res=RES)
    port.load_state_dict(state_dict_from_flax(variables, 'hmr', 'resnet18'))
    tassets = {g: assets_from_jax(a) for g, a in jassets.items()}
    jreg = np.asarray(jassets['neutral'].j_regressor_h36m)
    return jmodel, variables, jassets, port.eval(), tassets, jreg


def _batch(seed):
    rng = np.random.RandomState(seed)
    K = np.tile(np.array([[300., 0., 80.], [0., 300., 60.], [0., 0., 1.]],
                         'f4'), (B, 1, 1))
    return {
        'img': rng.rand(B, RES, RES, 3).astype('f4'),
        'pose': (rng.randn(B, 72) * 0.2).astype('f4'),
        'betas': (rng.randn(B, 10) * 0.5).astype('f4'),
        'gender': np.array([0, 1, 1, 0], np.int32),
        'scale': (rng.rand(B) * 0.3 + 0.5).astype('f4'),
        'center': (rng.rand(B, 2) * 40 + 60).astype('f4'),
        'orig_shape': np.tile(np.array([[120., 160.]], 'f4'), (B, 1)),
        'cam_rotmat': np.tile(np.eye(3, dtype='f4'), (B, 1, 1)),
        'cam_intrinsics': K,
    }


@pytest.mark.parametrize('use_gender', [False, True])
def test_eval_step_matches_jax(models, use_gender):
    jmodel, variables, jassets, port, tassets, jreg = models
    batch = _batch(seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch['img'] = (jbatch['img'] - JC.IMG_NORM_MEAN) / JC.IMG_NORM_STD
    jstep = jax_make_eval_step(jmodel, jassets, jreg, use_gender=use_gender)
    jout, j14, j24, v2v = jstep(variables, jbatch)

    step = TL.make_eval_step(port, tassets, jreg, use_gender=use_gender)
    with torch.inference_mode():
        out, t14, t24, tv2v = step({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    np.testing.assert_allclose(out['smpl_vertices'].numpy(),
                               np.asarray(jout['smpl_vertices']),
                               atol=VERTS_M)
    for got, want in ((t14, j14), (t24, j24)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=METRIC_M, err_msg=k)
    np.testing.assert_allclose(tv2v.numpy(), np.asarray(v2v), atol=METRIC_M)


def test_gendered_blend_picks_female_where_gender_is_1(models):
    """Each sample takes the female mesh where gender == 1 and the male
    one otherwise (-1, absent, counts as male, as in the reference)."""
    *_, tassets, _ = models
    rng = np.random.RandomState(5)
    pose = torch.from_numpy((rng.randn(3, 72) * 0.2).astype('f4'))
    betas = torch.from_numpy((rng.randn(3, 10) * 0.5).astype('f4'))
    gender = torch.tensor([1, 0, -1], dtype=torch.int32)
    verts, joints = TL._gendered_gt_mesh(tassets, pose, betas, gender)
    for g, rows in (('female', [0]), ('male', [1, 2])):
        v, j = TL._gendered_gt_mesh({'neutral': tassets[g]}, pose, betas,
                                    gender)
        torch.testing.assert_close(verts[rows], v[rows], rtol=0, atol=0)
        torch.testing.assert_close(joints[rows], j[rows], rtol=0, atol=0)


def _offline_inputs(seed, N=300):
    rng = np.random.RandomState(seed)
    Q = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(N)])
    Q *= np.sign(np.linalg.det(Q))[:, None, None]        # rotations
    return {
        'pred_vertices': (rng.randn(N, V, 3) * 0.3).astype('f4'),
        'pred_cam_rotmat': Q.astype('f4'),
        'gt_pose': (rng.randn(N, 72) * 0.2).astype('f4'),
        'gt_betas': (rng.randn(N, 10) * 0.5).astype('f4'),
        'gt_pose_cam': (rng.randn(N, 72) * 0.2).astype('f4'),
        'gt_cam_rotmat': Q[::-1].copy().astype('f4'),
    }


@pytest.mark.parametrize('dataset', ['3dpw-test-cam', 'spec-syn',
                                     'spec-mtp'])
def test_compute_error_matches_jax(models, dataset):
    *_, jassets, _, tassets, jreg = models
    inputs = _offline_inputs(seed=11)
    if dataset == 'spec-syn':
        inputs.pop('gt_pose_cam')
    else:
        inputs.pop('gt_cam_rotmat')
    want = jax_compute_error(dataset, assets=jassets['neutral'],
                             j_regressor_h36m=jreg, **inputs)
    got = TE.compute_error(dataset, assets=tassets['neutral'],
                           j_regressor_h36m=jreg, device='cpu', **inputs)
    assert got['protocol'] == want['protocol'] == (
        'j14' if dataset.startswith('3dpw') else 'j24')
    assert set(got) == set(want)
    for k in want:
        if k != 'protocol':
            assert abs(got[k] - want[k]) <= METRIC_MM, (k, got[k], want[k])


def test_compute_error_pads_the_last_chunk(models):
    """300 samples in chunks of 256 give what one chunk of 300 gives: the
    padding rows of the last chunk are dropped before the means."""
    *_, tassets, jreg = models
    inputs = _offline_inputs(seed=12)
    inputs.pop('gt_cam_rotmat')
    kw = dict(assets=tassets['neutral'], j_regressor_h36m=jreg,
              device='cpu', **inputs)
    chunked = TE.compute_error('3dpw-test-cam', **kw)
    whole = TE.compute_error('3dpw-test-cam', chunk=300, **kw)
    for k in chunked:
        if k != 'protocol':
            assert chunked[k] == pytest.approx(whole[k], abs=1e-4)


def test_graph_bodies_are_capturable(models):
    """The eval step's captured part and the offline chunk's build no
    tensor from host data, read no device value on the host and take no
    data-dependent shape after a warm-up (the check of
    tests/test_torch_graphs.py)."""
    from tests.test_torch_graphs import _uncapturable_ops

    *_, port, tassets, jreg = models
    step = TL.make_eval_step(port, tassets, jreg, use_gender=True)
    batch = [torch.from_numpy(_batch(seed=4)[k]) for k in TL.BATCH_KEYS]
    with torch.inference_mode():
        assert _uncapturable_ops(step.head.fn, *batch) == []
        for protocol in ('j14', 'j24'):
            stage = TE._chunk_stage(tassets['neutral'], jreg, protocol,
                                    torch.device('cpu'))
            x = _offline_inputs(seed=13, N=8)
            args = [torch.from_numpy(x[k]) for k in
                    ('gt_pose', 'gt_pose_cam', 'gt_betas', 'gt_cam_rotmat')]
            args += [torch.tensor(True), torch.from_numpy(x['pred_vertices']),
                     torch.from_numpy(x['pred_cam_rotmat'])]
            assert _uncapturable_ops(stage.fn, *args) == []


def test_unported_options_raise_and_name_their_item(models, tmp_path):
    from spec_tpu_torch.data.cam_dataset import CamDataset
    from spec_tpu_torch.data.loader import DataLoader

    *_, port, tassets, jreg = models
    with pytest.raises(NotImplementedError, match='item 12'):
        TL.make_eval_step(port, tassets, jreg, mesh=object())
    # save_images is ported: it renders (test_save_images_matches_jax)
    summary, _ = TL.evaluate_dataset(port, None, [], tassets, jreg,
                                     save_images=True)
    assert np.isnan(summary['val_mpjpe'])
    with pytest.raises(NotImplementedError, match='item 12'):
        TL.evaluate_dataset(port, None, [], tassets, jreg, mesh=object())
    with pytest.raises(SystemExit, match='in-the-wild'):
        TL.evaluate_dataset(port, None, [], tassets, jreg,
                            dataset_name='coco')
    npz = tmp_path / 'a.npz'
    np.savez(npz, imgname=np.array(['x.png']), scale=np.ones(1, 'f4'),
             center=np.zeros((1, 2), 'f4'))
    # fast_decode and the region cache are ported
    # (tests/test_torch_native_loader.py)
    for kw in ({'fast_decode': True}, {'region_cache_dir': str(tmp_path)}):
        ds = CamDataset(str(npz), str(tmp_path), 'x', **kw)
        assert ds.fast_decode or ds._region_cache is not None
    # training mode and occluders are ported (tests/test_torch_train_data.py)
    assert CamDataset(str(npz), str(tmp_path), 'x', is_train=True,
                      occluders=[]).is_train
    with pytest.raises(NotImplementedError, match='item 12'):
        DataLoader([1, 2], batch_size=2, process_id=1, process_count=2)


def _eval_batches(seed, disp):
    """Two loader batches as ``evaluate_dataset`` takes them (numpy)."""
    out = []
    for i in range(2):
        b = _batch(seed + i)
        rng = np.random.RandomState(seed + 10 + i)
        b['cam_int'] = b.pop('cam_intrinsics')
        b['pred_cam_rotmat'] = np.tile(
            np.array([[1, 0, 0], [0, 0.995, -0.0998], [0, 0.0998, 0.995]],
                     'f4'), (B, 1, 1))
        b['pred_cam_int'] = (b['cam_int'] * np.array(
            [[1.1], [1.1], [1]], 'f4')).astype('f4')
        b['imgname'] = [f'im{i}_{k}.jpg' for k in range(B)]
        b['dataset_name'] = ['x'] * B
        if disp:
            b['disp_img'] = rng.rand(B, 96, 96, 3).astype('f4')
        out.append(b)
    return out


@pytest.mark.parametrize('case', ['gt_cam', 'camcalib_disp', 'coco'])
def test_save_images_matches_jax(models, tmp_path, tmp_path_factory, case,
                                 monkeypatch):
    """``save_images`` writes ``val_images/<dataset>_b<idx>.jpg`` for the
    first sample of every ``save_freq``-th batch, rendered with the
    metrics pass's camera: the same files as the JAX package's, within
    RENDER_LEVELS. The coco pass is qualitative: zero errors."""
    import cv2

    import spec_tpu.native as JN
    from spec_tpu.eval.eval_loop import evaluate_dataset as jax_evaluate

    monkeypatch.setattr(JN, '_SO', str(tmp_path_factory.mktemp('jn')
                                       / '_native.so'))
    monkeypatch.setattr(JN, '_lib', None)
    monkeypatch.setattr(JN, '_failed', False)
    jmodel, variables, jassets, port, tassets, jreg = models
    name = 'coco' if case == 'coco' else '3dpw-test-cam'
    use_gt_cam = case == 'gt_cam'
    batches = _eval_batches(21, disp=case == 'camcalib_disp')
    kw = dict(use_gt_cam=use_gt_cam, save_results=False, save_images=True,
              save_freq=1, dataset_name=name)
    got, _ = TL.evaluate_dataset(port, None, batches, tassets, jreg,
                                 logdir=str(tmp_path / 'port'), **kw)
    want, _ = jax_evaluate(jmodel, variables, batches, jassets, jreg,
                           logdir=str(tmp_path / 'jax'), **kw)
    files = sorted(os.listdir(tmp_path / 'port' / 'val_images'))
    assert files == sorted(os.listdir(tmp_path / 'jax' / 'val_images')) \
        == [f'{name}_b00000.jpg', f'{name}_b00001.jpg']
    for f in files:
        a = cv2.imread(str(tmp_path / 'port' / 'val_images' / f))
        b = cv2.imread(str(tmp_path / 'jax' / 'val_images' / f))
        res = 96 if case == 'camcalib_disp' else RES
        assert a.shape == b.shape == (res, 3 * res, 3)
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.mean() <= RENDER_LEVELS['mean'], d.mean()
        assert (d > 16).mean() <= RENDER_LEVELS['far_share']
        # the overlay and side panels hold a mesh
        assert (a[:, res:] > 0).any()
    if case == 'coco':
        assert got['val_mpjpe'] == want['val_mpjpe'] == 0.0
    else:
        for k in want:
            assert abs(got[k] - want[k]) <= METRIC_MM, (k, got[k], want[k])


