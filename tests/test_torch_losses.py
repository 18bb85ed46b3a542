"""spec_tpu_torch.losses against spec_tpu.losses on the CPU: every loss,
its value and its gradient with respect to each prediction
(``jax.grad`` against ``torch.autograd``), on seeded inputs with
partly-masked rows; and the CamCalib bin encoders.

Limits: values within 1e-5 relative (VALUE_RTOL), gradients within 1e-5
of each gradient's largest entry (GRAD_RTOL); fp32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import bins as JB
from spec_tpu.core import geometry as JG
from spec_tpu import losses as JL
from spec_tpu_torch.core import bins as TB
from spec_tpu_torch import losses as TL

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-5
B = 5


def _inputs(seed):
    """A SPEC prediction and GT batch: two rows without SMPL, one
    without 3D joints, keypoint confidences in {0, 0.5, 1}."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype('f4')  # noqa: E731
    rot = np.asarray(JG.rodrigues(jnp.asarray(f(B, 24, 3) * 0.5)))
    pred = {
        'pred_pose': rot, 'pred_shape': f(B, 10),
        'pred_cam': np.concatenate([rng.rand(B, 1) * 1.5 - 0.2,
                                    f(B, 2) * 0.1], 1).astype('f4'),
        'smpl_joints3d': f(B, 49, 3) * 0.5,
        'smpl_vertices': f(B, 40, 3) * 0.5,
        'smpl_joints2d': (rng.rand(B, 49, 2) * 1500).astype('f4'),
        'pred_pose_6d': f(B, 144), 'pred_pose6d_logvar': f(B, 144) * 0.3,
        'pred_betas_logvar': f(B, 10) * 0.3,
    }
    conf = rng.choice([0.0, 0.5, 1.0], size=(B, 49, 1)).astype('f4')
    gt = {
        'pose': f(B, 72) * 0.3, 'betas': f(B, 10),
        'pose_conf': rng.rand(B, 24).astype('f4'),
        'pose_3d': np.concatenate([f(B, 24, 3) * 0.5,
                                   rng.rand(B, 24, 1).astype('f4')], -1),
        'vertices': f(B, 40, 3) * 0.5,
        'keypoints_orig': np.concatenate(
            [(rng.rand(B, 49, 2) * 1500).astype('f4'), conf], -1),
        'keypoints': np.concatenate([f(B, 49, 2) * 0.5, conf], -1),
        'has_smpl': np.array([1, 0, 1, 1, 0], 'f4'),
        'has_pose_3d': np.array([1, 1, 0, 1, 1], 'f4'),
        'orig_shape': np.tile(np.array([[1080.0, 1920.0]], 'f4'), (B, 1)),
        'scale': (rng.rand(B) + 0.8).astype('f4'),
    }
    return pred, gt


def _hmr_cases():
    """name -> (jax fn, port fn, the prediction keys differentiated),
    each fn(pred, gt) -> scalar."""
    def both(name, call, keys):
        return name, (lambda P, G: call(JL, P, G),
                      lambda P, G: call(TL, P, G), keys)

    cfg = dict(shape_loss_weight=0.5, openpose_train_weight=0.3)
    return dict([
        both('smpl_param_loss', lambda L, P, G: sum(L.smpl_param_loss(
            P['pred_pose'], P['pred_shape'], G['pose'], G['betas'],
            G['has_smpl'], G['pose_conf'])), ('pred_pose', 'pred_shape')),
        both('keypoint_3d_loss', lambda L, P, G: L.keypoint_3d_loss(
            P['smpl_joints3d'], G['pose_3d'], G['has_pose_3d']),
            ('smpl_joints3d',)),
        both('shape_loss', lambda L, P, G: L.shape_loss(
            P['smpl_vertices'], G['vertices'], G['has_smpl']),
            ('smpl_vertices',)),
        both('projected_keypoint_loss', lambda L, P, G:
             L.projected_keypoint_loss(
                 P['smpl_joints2d'] / 1500.0, G['keypoints'], 0.3,
                 1.0).mean(), ('smpl_joints2d',)),
        both('gaussian_nll', lambda L, P, G: L.gaussian_nll(
            P['pred_shape'], P['pred_betas_logvar'], G['betas']),
            ('pred_shape', 'pred_betas_logvar')),
        both('smpl_param_loss_uncertainty', lambda L, P, G: sum(
            L.smpl_param_loss_uncertainty(
                P['pred_pose_6d'], P['pred_pose6d_logvar'],
                P['pred_shape'], P['pred_betas_logvar'], G['pose'],
                G['betas'], G['has_smpl'])),
            ('pred_pose_6d', 'pred_pose6d_logvar', 'pred_shape',
             'pred_betas_logvar')),
        both('hmr_cam_loss', lambda L, P, G: L.hmr_cam_loss(
            P, G, L.HMRLossConfig(**cfg))[0],
            ('pred_pose', 'pred_shape', 'pred_cam', 'smpl_joints3d',
             'smpl_vertices', 'smpl_joints2d')),
        both('hmr_loss', lambda L, P, G: L.hmr_loss(
            dict(P, smpl_joints2d=P['smpl_joints2d'] / 1500.0), G,
            L.HMRLossConfig(**cfg))[0],
            ('pred_pose', 'pred_shape', 'pred_cam', 'smpl_joints3d',
             'smpl_vertices', 'smpl_joints2d')),
    ])


HMR_CASES = _hmr_cases()


def _value_and_grads(jfn, tfn, pred, gt, keys):
    jpred = {k: jnp.asarray(v) for k, v in pred.items()}
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}

    def jloss(sub):
        return jfn(dict(jpred, **sub), jgt)

    jval, jgrad = jax.value_and_grad(jloss)({k: jpred[k] for k in keys})
    tpred = {k: torch.from_numpy(v.copy()) for k, v in pred.items()}
    for k in keys:
        tpred[k].requires_grad_(True)
    tgt = {k: torch.from_numpy(v.copy()) for k, v in gt.items()}
    tval = tfn(tpred, tgt)
    tgrads = torch.autograd.grad(tval, [tpred[k] for k in keys])
    return jval, jgrad, tval, dict(zip(keys, tgrads))


def _hold(jval, jgrad, tval, tgrad):
    np.testing.assert_allclose(float(tval.detach()), float(jval),
                               rtol=VALUE_RTOL)
    for k, g in jgrad.items():
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-30)
        err = np.abs(tgrad[k].numpy() - g).max() / scale
        assert err <= GRAD_RTOL, (k, err)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name', sorted(HMR_CASES))
def test_hmr_loss_matches_jax(name, seed):
    jfn, tfn, keys = HMR_CASES[name]
    pred, gt = _inputs(seed)
    _hold(*_value_and_grads(jfn, tfn, pred, gt, keys))


def test_hmr_cam_loss_dict_and_cam_clamp():
    """Every term of the loss dict; s below -4 clamps (finite, zero
    gradient there) as in the JAX package."""
    pred, gt = _inputs(3)
    pred['pred_cam'][0, 0] = -7.0
    jt, jd = JL.hmr_cam_loss({k: jnp.asarray(v) for k, v in pred.items()},
                             {k: jnp.asarray(v) for k, v in gt.items()})
    tpred = {k: torch.from_numpy(v.copy()) for k, v in pred.items()}
    tpred['pred_cam'].requires_grad_(True)
    tt, td = TL.hmr_cam_loss(
        tpred, {k: torch.from_numpy(v.copy()) for k, v in gt.items()})
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]),
                                   rtol=VALUE_RTOL, err_msg=k)
    assert np.isfinite(float(tt))
    g, = torch.autograd.grad(tt, [tpred['pred_cam']])
    assert float(g[0, 0]) == 0.0


def _logits(seed, n=B):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 256) * 2).astype('f4'), rng


@pytest.mark.parametrize('loss_type', ['ce', 'kl', 'softargmax_l2',
                                       'softargmax_biased_l2'])
def test_camera_regressor_loss_matches_jax(loss_type):
    (lv, rng), (lp, _), (lr_, _) = (_logits(s) for s in (0, 1, 2))
    if loss_type in ('ce', 'kl'):
        tgt = [rng.randint(0, 256, B).astype(np.int32) for _ in range(3)]
    else:
        tgt = [rng.uniform(-1, 1, B).astype('f4') for _ in range(3)]
    w = dict(vfov_loss_weight=10.0, pitch_loss_weight=2.0,
             roll_loss_weight=0.5)

    def jfn(lv, lp, lr_):
        return JL.camera_regressor_loss(lv, lp, lr_, *map(jnp.asarray, tgt),
                                        loss_type=loss_type, **w)[0]

    jval, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(lv), jnp.asarray(lp), jnp.asarray(lr_))
    tl = [torch.from_numpy(x.copy()).requires_grad_(True)
          for x in (lv, lp, lr_)]
    tval, tdict = TL.camera_regressor_loss(
        *tl, *[torch.from_numpy(t) for t in tgt], loss_type=loss_type, **w)
    assert set(tdict) == {'loss', 'vfov_loss', 'pitch_loss', 'roll_loss'}
    _hold(jval, dict(enumerate(jgrads)), tval,
          dict(enumerate(torch.autograd.grad(tval, tl))))


def test_camera_regressor_loss_unknown_type_raises():
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError):
        TL.camera_regressor_loss(x, x, x, x[:, 0], x[:, 0], x[:, 0],
                                 loss_type='l1')


@pytest.mark.parametrize('weighted', [False, True])
def test_joints_mse_loss_matches_jax(weighted):
    rng = np.random.RandomState(4)
    pred, gt = (rng.randn(2, 7, 8, 6).astype('f4') for _ in range(2))
    tw = (rng.rand(2, 7) > 0.3).astype('f4') if weighted else None
    jfn = lambda p: JL.joints_mse_loss(  # noqa: E731
        p, jnp.asarray(gt), None if tw is None else jnp.asarray(tw))
    jval, jg = jax.value_and_grad(jfn)(jnp.asarray(pred))
    tp = torch.from_numpy(pred.copy()).requires_grad_(True)
    tval = TL.joints_mse_loss(tp, torch.from_numpy(gt),
                              None if tw is None else torch.from_numpy(tw))
    _hold(jval, {0: jg}, tval, {0: torch.autograd.grad(tval, [tp])[0]})


@pytest.mark.parametrize('weighted', [False, True])
def test_pixelwise_cross_entropy_matches_jax(weighted):
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 6, 5, 4).astype('f4')
    target = rng.randint(-1, 6, (2, 5, 4)).astype(np.int32)
    cw = rng.rand(6).astype('f4') + 0.5 if weighted else None
    jfn = lambda x: JL.pixelwise_cross_entropy(  # noqa: E731
        x, jnp.asarray(target),
        class_weights=None if cw is None else jnp.asarray(cw))
    jval, jg = jax.value_and_grad(jfn)(jnp.asarray(logits))
    tx = torch.from_numpy(logits.copy()).requires_grad_(True)
    tval = TL.pixelwise_cross_entropy(
        tx, torch.from_numpy(target),
        class_weights=None if cw is None else torch.from_numpy(cw))
    _hold(jval, {0: jg}, tval, {0: torch.autograd.grad(tval, [tx])[0]})


def test_bin_encoders_match_jax():
    rng = np.random.RandomState(6)
    for name, lo, hi in (('vfov', 0.2, 2.2), ('pitch', -0.7, 0.7),
                         ('roll', -0.7, 0.7)):
        a = rng.uniform(lo, hi, 50).astype('f4')
        np.testing.assert_array_equal(
            getattr(TB, f'{name}2soft_idx')(a),
            np.asarray(getattr(JB, f'{name}2soft_idx')(a)))
        edges = getattr(TB, f'{name.upper()}_EDGES')
        np.testing.assert_array_equal(
            TB.angle_to_bin_index(a, edges),
            np.asarray(JB.angle_to_bin_index(a, edges)))
    t = torch.from_numpy(rng.uniform(0.3, 2.0, 8).astype('f4'))
    np.testing.assert_allclose(
        TB.soft_idx_to_angle(TB.vfov2soft_idx(t), *TB.VFOV_RANGE).numpy(),
        t.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        TB.angle_to_soft_idx(t, 0.0, 4.0).numpy(),
        np.asarray(JB.angle_to_soft_idx(jnp.asarray(t.numpy()), 0.0, 4.0)),
        rtol=1e-6)
