"""spec_tpu_torch.core.{geometry,bins} vs spec_tpu.core.{geometry,bins} on
the same numpy inputs (CPU, fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import bins as jbins
from spec_tpu.core import geometry as JG
from spec_tpu_torch.core import bins as tbins
from spec_tpu_torch.core import geometry as TG

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def test_rot6d_to_rotmat(rng):
    x = rng.randn(5, 24, 6).astype(np.float32)
    _close(TG.rot6d_to_rotmat(_t(x)), JG.rot6d_to_rotmat(jnp.asarray(x)))


def test_rodrigues_including_tiny_angles(rng):
    aa = rng.randn(4, 24, 3).astype(np.float32) * 0.5
    aa[0, :3] = rng.randn(3, 3).astype(np.float32) * 1e-6   # Taylor branch
    aa[1, 0] = 0.0
    _close(TG.rodrigues(_t(aa)), JG.rodrigues(jnp.asarray(aa)))


def test_euler_to_rotmat(rng):
    e = (rng.rand(6, 3).astype(np.float32) - 0.5) * 2.0
    _close(TG.euler_to_rotmat(_t(e)), JG.euler_to_rotmat(jnp.asarray(e)))


def test_perspective_projection(rng):
    B, N = 3, 49
    pts = rng.randn(B, N, 3).astype(np.float32) * 0.5
    R = np.asarray(JG.euler_to_rotmat(jnp.asarray(
        rng.randn(B, 3).astype(np.float32) * 0.2)))
    t = np.stack([rng.randn(B) * 0.1, rng.randn(B) * 0.1,
                  rng.rand(B) * 2 + 4], 1).astype(np.float32)
    K = np.asarray(JG.build_cam_intrinsics(
        jnp.asarray(rng.rand(B).astype(np.float32) + 1.0),
        jnp.asarray(rng.rand(B).astype(np.float32)),
        jnp.asarray(rng.rand(B).astype(np.float32))))
    _close(TG.perspective_projection(_t(pts), _t(R), _t(t), _t(K)),
           JG.perspective_projection(jnp.asarray(pts), jnp.asarray(R),
                                     jnp.asarray(t), jnp.asarray(K)))


def test_weak_perspective_to_full_translation(rng):
    B = 6
    cam = np.stack([rng.rand(B) + 0.5, rng.randn(B) * 0.1,
                    rng.randn(B) * 0.1], 1).astype(np.float32)
    center = (rng.rand(B, 2) * 200).astype(np.float32)
    scale = (rng.rand(B) + 0.3).astype(np.float32)
    w = np.full(B, 320.0, np.float32)
    h = np.full(B, 240.0, np.float32)
    f = (rng.rand(B) * 300 + 200).astype(np.float32)
    port = TG.weak_perspective_to_full_translation(
        _t(cam), _t(center), _t(scale), _t(w), _t(h), _t(f))
    ref = JG.weak_perspective_to_full_translation(*map(
        jnp.asarray, (cam, center, scale, w, h, f)))
    _close(port, ref, rtol=1e-6)


def test_weak_perspective_projection_and_cam_t(rng):
    pts = rng.randn(2, 49, 3).astype(np.float32) * 0.5
    cam = np.stack([rng.rand(2) + 0.5, rng.randn(2) * 0.1,
                    rng.randn(2) * 0.1], 1).astype(np.float32)
    _close(TG.weak_perspective_projection(_t(pts), _t(cam)),
           JG.weak_perspective_projection(jnp.asarray(pts),
                                          jnp.asarray(cam)), rtol=1e-6)
    _close(TG.weak_perspective_cam_t(_t(cam)),
           JG.weak_perspective_cam_t(jnp.asarray(cam)), rtol=1e-6)


def test_focal_length_and_intrinsics(rng):
    vfov = (rng.rand(5) * 1.5 + 0.3).astype(np.float32)
    h = (rng.rand(5) * 500 + 100).astype(np.float32)
    w = (rng.rand(5) * 500 + 100).astype(np.float32)
    f_port = TG.focal_length_from_vfov(_t(vfov), _t(h))
    f_ref = JG.focal_length_from_vfov(jnp.asarray(vfov), jnp.asarray(h))
    _close(f_port, f_ref, rtol=1e-6)
    _close(TG.build_cam_intrinsics(_t(f_ref), _t(w), _t(h)),
           JG.build_cam_intrinsics(f_ref, jnp.asarray(w), jnp.asarray(h)))


@pytest.mark.parametrize('name', [
    'VFOV_EDGES', 'PITCH_EDGES', 'ROLL_EDGES', 'HORIZON_EDGES',
    'LEGACY_ROLL_EDGES', 'VFOV_CENTERS', 'PITCH_CENTERS', 'ROLL_CENTERS',
    'HORIZON_CENTERS', 'LEGACY_ROLL_CENTERS'])
def test_bin_tables_equal(name):
    np.testing.assert_array_equal(getattr(tbins, name),
                                  np.asarray(getattr(jbins, name)))


@pytest.mark.parametrize('loss_type,legacy', [
    ('kl', False), ('ce', False), ('softargmax_l2', False),
    ('softargmax_biased_l2', False), ('softargmax_biased_l2', True)])
def test_convert_preds_to_angles(rng, loss_type, legacy):
    logits = [rng.randn(7, 256).astype(np.float32) * 3 for _ in range(3)]
    port = tbins.convert_preds_to_angles(*map(_t, logits),
                                         loss_type=loss_type, legacy=legacy)
    ref = jbins.convert_preds_to_angles(*map(jnp.asarray, logits),
                                        loss_type=loss_type, legacy=legacy)
    for p, r in zip(port, ref):
        _close(p, r)


def test_unknown_loss_type_raises():
    x = torch.zeros(1, 256)
    with pytest.raises(ValueError, match='unknown loss_type'):
        tbins.convert_preds_to_angles(x, x, x, loss_type='nope')
