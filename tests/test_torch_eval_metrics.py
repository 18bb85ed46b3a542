"""spec_tpu_torch's eval math against spec_tpu's on the CPU, on the same
seeded numpy inputs: Procrustes, the rotation log map, every function of
eval/metrics.py (j14 and j17), and MetricAccumulator.

Limits: aligned points and metric values within 1e-6 m (fp32 on both
sides; SVD and matmuls from other libraries differ by a few ulps at
joint coordinates of about a meter); axis-angle within 1e-5 rad away
from theta = pi, rotation matrices rebuilt from it within 1e-5 near 0
and pi (where the axis-angle itself is ambiguous).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import geometry as JG
from spec_tpu.eval import metrics as JM
from spec_tpu.eval.evaluator import MetricAccumulator as JAcc
from spec_tpu_torch.core import geometry as TG
from spec_tpu_torch.eval import metrics as TM
from spec_tpu_torch.eval.evaluator import MetricAccumulator as TAcc

ATOL_M = 1e-6
ATOL_RAD = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _joint_sets(rng, B=16, J=14, scale=0.25):
    """Pelvis-centred joint sets in meters: a set, and a rotated, scaled,
    noisy copy of it."""
    S1 = (rng.randn(B, J, 3) * scale).astype(np.float32)
    Q = np.linalg.qr(rng.randn(3, 3))[0]
    S2 = (S1 @ Q.astype(np.float32)) * 1.1 + (
        rng.randn(B, J, 3) * 0.05).astype(np.float32)
    return S1, S2.astype(np.float32)


def _procrustes_case(name, rng):
    S1, S2 = _joint_sets(rng)
    if name == 'collinear':
        # three collinear joints in every set (a rank-deficient subset)
        S1[:, :3] = np.linspace(-0.3, 0.3, 3)[None, :, None] * np.array(
            [0.2, 0.5, 0.8], np.float32)
    elif name == 'reflection':
        # S2 is a mirror image: the best orthogonal map has det -1, so
        # the guard must flip the last singular direction
        S2 = S1 * np.array([-1.0, 1.0, 1.0], np.float32)
    elif name == 'planar':
        S1[..., 2] = 0.0
    return S1, S2


@pytest.mark.parametrize('case', ['random', 'collinear', 'reflection',
                                  'planar'])
def test_procrustes_align_matches_jax(case, rng):
    S1, S2 = _procrustes_case(case, rng)
    want = np.asarray(JG.procrustes_align(jnp.asarray(S1), jnp.asarray(S2)))
    got = TG.procrustes_align(_t(S1), _t(S2)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_M)
    if case == 'reflection':
        # a mirror cannot be undone by a rotation: the aligned set stays
        # away from S2
        assert np.abs(got - S2).max() > 1e-2


def _rotations(rng, n, angle):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = angle if np.isscalar(angle) else angle
    return (axis * np.reshape(theta, (-1, 1))).astype(np.float32)


@pytest.mark.parametrize('fn', ['rotmat_to_quat', 'rotmat_to_aa'])
def test_rotation_log_map_matches_jax(fn, rng):
    aa = _rotations(rng, 256, rng.uniform(0.05, 3.0, 256))
    R = np.asarray(JG.rodrigues(jnp.asarray(aa)))
    want = np.asarray(getattr(JG, fn)(jnp.asarray(R)))
    got = getattr(TG, fn)(_t(R)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_RAD)


def test_quat_to_aa_matches_jax(rng):
    q = rng.randn(128, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:8, 1:] *= 1e-7                               # the small-angle branch
    want = np.asarray(JG.quat_to_aa(jnp.asarray(q)))
    np.testing.assert_allclose(TG.quat_to_aa(_t(q)).numpy(), want,
                               atol=ATOL_RAD)


@pytest.mark.parametrize('angle', [0.0, 1e-4, np.pi - 1e-4, np.pi])
def test_rotmat_to_aa_near_zero_and_pi_rebuilds_the_rotation(angle, rng):
    aa = _rotations(rng, 64, np.full(64, angle))
    R = np.asarray(JG.rodrigues(jnp.asarray(aa)))
    want = np.asarray(JG.rodrigues(JG.rotmat_to_aa(jnp.asarray(R))))
    got = np.asarray(JG.rodrigues(jnp.asarray(
        TG.rotmat_to_aa(_t(R)).numpy())))
    np.testing.assert_allclose(got, want, atol=ATOL_RAD)
    np.testing.assert_allclose(got, R, atol=1e-4)


def test_camera_helpers_match_jax(rng):
    f = (rng.rand(16) * 1000 + 300).astype(np.float32)
    h = (rng.rand(16) * 800 + 200).astype(np.float32)
    np.testing.assert_allclose(
        TG.vfov_from_focal_length(_t(f), _t(h)).numpy(),
        np.asarray(JG.vfov_from_focal_length(jnp.asarray(f),
                                             jnp.asarray(h))), atol=1e-6)
    for pitch, roll in rng.randn(8, 2):
        np.testing.assert_array_equal(
            TG.euler_pitch_roll_np(pitch, roll),
            JG.euler_pitch_roll_np(pitch, roll))


def _meshes(rng, B=6, V=200):
    pred = (rng.randn(B, V, 3) * 0.3).astype(np.float32)
    gt = pred + (rng.randn(B, V, 3) * 0.03).astype(np.float32)
    jreg = rng.rand(17, V).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    return pred, gt, jreg


@pytest.mark.parametrize('fn', ['per_joint_error', 'mpjpe', 'pa_mpjpe',
                                'v2v_error', 'rotate_points',
                                'regress_h36m'])
def test_metric_matches_jax(fn, rng):
    pred, gt, jreg = _meshes(rng)
    if fn == 'rotate_points':
        args = (np.asarray(JG.rodrigues(jnp.asarray(
            (rng.randn(6, 3) * 0.5).astype(np.float32)))), pred)
    elif fn == 'regress_h36m':
        args = (pred, jreg)
    else:
        args = (pred[:, :14], gt[:, :14])
    want = getattr(JM, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(TM, fn)(*[_t(a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_M)


@pytest.mark.parametrize('subset', ['j14', 'j17'])
def test_eval_mesh_j14_matches_jax(subset, rng):
    pred, gt, jreg = _meshes(rng)
    want = JM.eval_mesh_j14(jnp.asarray(pred), jnp.asarray(gt),
                            jnp.asarray(jreg), subset=subset)
    got = TM.eval_mesh_j14(_t(pred), _t(gt), _t(jreg), subset=subset)
    assert set(got) == set(want)
    n = 17 if subset == 'j17' else 14
    assert got['per_joint_mpjpe'].shape == (6, n)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL_M, err_msg=k)


def test_eval_joints_24_matches_jax(rng):
    p = (rng.randn(6, 24, 3) * 0.3).astype(np.float32)
    g = p + (rng.randn(6, 24, 3) * 0.03).astype(np.float32)
    want = JM.eval_joints_24(jnp.asarray(p), jnp.asarray(g))
    got = TM.eval_joints_24(_t(p), _t(g))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL_M, err_msg=k)


def test_metrics_ignore_an_outer_bf16_autocast(rng):
    """The eval step's model may run under bf16 autocast; the metric
    einsums must still be exact fp32."""
    pred, gt, jreg = _meshes(rng, V=6890 // 10)
    want = TM.eval_mesh_j14(_t(pred), _t(gt), _t(jreg))
    with torch.autocast('cpu', dtype=torch.bfloat16):
        got = TM.eval_mesh_j14(_t(pred), _t(gt), _t(jreg))
        rot = TM.rotate_points(_t(np.eye(3)[None].repeat(6, 0)), _t(pred))
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert rot.dtype == torch.float32


def test_regress_h36m_joints_matches_jax(rng):
    from spec_tpu.core import smpl as JS
    from spec_tpu_torch.core import smpl as TS
    from spec_tpu_torch.utils.checkpoints import assets_from_jax

    jassets = JS.create_test_assets(num_vertices=300)
    verts = (rng.randn(4, 300, 3) * 0.3).astype(np.float32)
    for subset in ('j14', 'j17'):
        want = JS.regress_h36m_joints(jassets, jnp.asarray(verts), subset)
        got = TS.regress_h36m_joints(assets_from_jax(jassets), _t(verts),
                                     subset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_M)


def _metric_batches(rng, n_batches=3, B=4):
    out = []
    for b in range(n_batches):
        j14 = {'per_joint_mpjpe': rng.rand(B, 14).astype(np.float32) * 0.1,
               'per_joint_pa': rng.rand(B, 14).astype(np.float32) * 0.05}
        j24 = {'per_joint_mpjpe': rng.rand(B, 24).astype(np.float32) * 0.1,
               'per_joint_pa': rng.rand(B, 24).astype(np.float32) * 0.05}
        pred = {'pred_pose': rng.randn(B, 24, 3, 3).astype(np.float32),
                'pred_shape': rng.randn(B, 10).astype(np.float32),
                'pred_cam': rng.randn(B, 3).astype(np.float32),
                'smpl_vertices': rng.randn(B, 20, 3).astype(np.float32)}
        names = [f'img{b}_{i}.jpg' for i in range(B)]
        valid = B - 1 if b == n_batches - 1 else None     # padded tail
        out.append((names, ['3dpw'] * B, j14, j24,
                    rng.rand(B).astype(np.float32) * 0.2, pred, valid))
    return out


@pytest.mark.parametrize('save_results', [True, False])
def test_metric_accumulator_matches_jax(save_results, rng):
    ref, port = JAcc(save_results), TAcc(save_results)
    for names, ds, j14, j24, v2v, pred, valid in _metric_batches(rng):
        ref.add_batch(names, ds, j14, j24, v2v, pred=pred,
                      valid_count=valid)
        # the port takes tensors, as its eval step returns them
        port.add_batch(names, ds, {k: _t(v) for k, v in j14.items()},
                       {k: _t(v) for k, v in j24.items()}, _t(v2v),
                       pred={k: _t(v) for k, v in pred.items()},
                       valid_count=valid)
    assert port.summary() == ref.summary()
    got, want = port.results_dict(), ref.results_dict()
    assert set(got) == set(want)
    assert len(got['imgname']) == 11
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port.reset()
    assert np.isnan(port.summary()['val_mpjpe'])
