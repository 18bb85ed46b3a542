"""spec_tpu_torch.ops.projection vs spec_tpu.ops.pallas.projection (the
Pallas kernel in interpret mode) and both packages'
perspective_projection, on the CPU, with inputs like
tools/tpu_checks.py's projection check. Budget: 1e-3 px."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import geometry as JG
from spec_tpu.ops.pallas.projection import project_points as jax_project
from spec_tpu_torch.core import geometry as TG
from spec_tpu_torch.ops import projection as TP

BUDGET = 1e-3   # px


def _inputs(rng, B, V):
    pts = rng.randn(B, V, 3).astype('f4') + np.array([0, 0, 5], 'f4')
    R = np.asarray(JG.euler_to_rotmat(
        jnp.asarray(rng.randn(B, 3).astype('f4') * 0.2)))
    t = rng.randn(B, 3).astype('f4') * 0.5
    K = np.asarray(JG.build_cam_intrinsics(
        jnp.full((B,), 1500.0), jnp.full((B,), 1920.0),
        jnp.full((B,), 1080.0)))
    return pts, np.array(R), t, np.array(K)


@pytest.mark.parametrize('B,V', [(8, 49), (3, 700), (80, 130)])
def test_plain_matches_pallas_and_perspective_projection(rng, B, V):
    pts, R, t, K = _inputs(rng, B, V)
    args_t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              (pts, R, t, K)]
    out = TP.project_points_plain(*args_t)
    assert tuple(out.shape) == (B, V, 2) and out.dtype == torch.float32
    kernel = np.asarray(jax_project(*(jnp.asarray(a) for a in
                                      (pts, R, t, K)), interpret=True))
    ref = np.asarray(JG.perspective_projection(
        jnp.asarray(pts), rotation=jnp.asarray(R),
        translation=jnp.asarray(t), cam_intrinsics=jnp.asarray(K)))
    port_ref = TG.perspective_projection(*args_t).numpy()
    for other in (kernel, ref, port_ref):
        assert np.abs(out.numpy() - other).max() <= BUDGET


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch(rng):
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in _inputs(rng, 4, 100)]
    before = TP.LAUNCHES
    out = TP.project_points(*args)
    assert TP.LAUNCHES == before
    torch.testing.assert_close(out, TP.project_points_plain(*args), rtol=0,
                               atol=0)


def test_depth_clamp_matches_jax(rng):
    """Points at or behind the camera divide by 1e-8, as in the JAX
    kernel (finite, huge pixels; relative budget)."""
    pts, R, t, K = _inputs(rng, 2, 20)
    pts[:, :5, 2] = -5.0 - t[:, None, 2]
    R[:] = np.eye(3, dtype='f4')
    out = TP.project_points_plain(*(torch.from_numpy(a) for a in
                                    (pts, R, t, K))).numpy()
    ref = np.asarray(jax_project(*(jnp.asarray(a) for a in (pts, R, t, K)),
                                 interpret=True))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=BUDGET)


@pytest.mark.parametrize('case,err', [
    ('points_dtype', TypeError), ('points_shape', ValueError),
    ('points_layout', ValueError), ('rotation_shape', ValueError),
    ('intrinsics_dtype', TypeError), ('device', ValueError),
    ('meta', ValueError)])
def test_wrapper_refuses_bad_operands(rng, case, err):
    pts, R, t, K = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in _inputs(rng, 2, 10))
    if case == 'points_dtype':
        pts = pts.double()
    elif case == 'points_shape':
        pts = pts[..., :2]
    elif case == 'points_layout':
        pts = pts.transpose(0, 1)
    elif case == 'rotation_shape':
        R = R[:, :2]
    elif case == 'intrinsics_dtype':
        K = K.to(torch.int64)
    elif case == 'device':
        t = t.to('meta')
    elif case == 'meta':
        pts, R, t, K = (a.to('meta') for a in (pts, R, t, K))
    before = TP.LAUNCHES
    with pytest.raises(err):
        TP.project_points(pts, R, t, K)
    assert TP.LAUNCHES == before
