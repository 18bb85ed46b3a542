"""spec_tpu_torch.pipeline.build_pipeline vs bench.build_pipeline, fp32,
on the CPU, with both stage-1 trunks: the CamCalib module (JAX 'flax')
and the folded-BN FusedResNet (JAX 'fused').

The JAX variables are initialized as ``bench.py`` does it, with BN
statistics randomized (centred, so that the trunks' features are not all
zero) so that folding is exercised, and reach the port
through ``state_dict_from_flax``. Both packages build the same synthetic
SMPL assets (checked below). Two differences on the JAX side, neither in
what is compared:

* only ``build_pipeline`` is compiled from ``bench.py``: importing the
  module would configure a persistent compile cache at a fixed path;
* its assets carry no packed LBS operands, because the Pallas LBS kernel
  runs on the CPU only in interpret mode; SMPL then takes the plain jnp
  ``lbs`` that the kernel is held to in tests/test_pallas_lbs.py (the
  port keeps K1's wrapper, on the CPU its plain version).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.ops.preprocess import spin_crop_corners
from spec_tpu_torch.ops import bottleneck as TB
from spec_tpu_torch.ops import lbs as TL
from spec_tpu_torch.pipeline import build_pipeline
from spec_tpu_torch.utils.checkpoints import state_dict_from_flax
from tests.test_torch_fused_resnet import randomize_bn_stats

FRAMES, H, W, IMG_RES = 2, 64, 96, 64
BENCH = pathlib.Path(__file__).resolve().parents[1] / 'bench.py'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_build_pipeline():
    """``bench.build_pipeline`` compiled from bench.py's source alone."""
    tree = ast.parse(BENCH.read_text())
    fn = [n for n in tree.body if isinstance(n, ast.FunctionDef)
          and n.name == 'build_pipeline']
    ns = {'jax': jax, 'jnp': jnp}
    exec(compile(ast.Module(body=fn, type_ignores=[]), str(BENCH), 'exec'),
         ns)
    return ns['build_pipeline']


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.RandomState(3)
    raw = (rng.rand(FRAMES, H, W, 3) * 255).astype('f4')
    center = (rng.rand(FRAMES, 2) * [30, 20] + [33, 22]).astype('f4')
    scale = (rng.rand(FRAMES) * 0.1 + 0.2).astype('f4')
    corners = spin_crop_corners(center, scale, res=IMG_RES)
    return rng, raw, corners, center, scale


@pytest.fixture(scope='module')
def jax_runs(inputs):
    rng, raw, corners, center, scale = inputs
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, 'with_packed_lbs', lambda assets: assets)
    try:
        out = {}
        for stage1 in ('flax', 'fused'):
            camcalib, spec, assets, pipeline = _bench_build_pipeline()(
                compute_dtype=jnp.float32, img_res=IMG_RES, stage1=stage1)
            if not out:
                from spec_tpu.core import geometry as G
                cc_vars = randomize_bn_stats(rng, camcalib.init(
                    jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))))
                img_w = jnp.full((1,), float(W))
                img_h = jnp.full((1,), float(H))
                K0 = G.build_cam_intrinsics(jnp.full((1,), 500.0), img_w,
                                            img_h)
                spec_vars = randomize_bn_stats(rng, spec.init(
                    jax.random.PRNGKey(1), assets,
                    jnp.zeros((1, IMG_RES, IMG_RES, 3)),
                    jnp.eye(3)[None], K0, jnp.ones((1,)),
                    jnp.ones((1, 2)), img_w, img_h))
                out['vars'] = (cc_vars, spec_vars)
                out['assets'] = assets
            cc_vars, spec_vars = out['vars']
            res = pipeline(cc_vars, spec_vars, jnp.asarray(raw),
                           jnp.asarray(corners), jnp.asarray(center),
                           jnp.asarray(scale))
            out[stage1] = [np.asarray(r) for r in res]
    finally:
        mp.undo()
    return out


def test_synthetic_assets_equal(jax_runs):
    from spec_tpu_torch.core.smpl import create_test_assets

    ja, ta = jax_runs['assets'], create_test_assets()
    for name in ('v_template', 'shapedirs', 'posedirs', 'j_regressor',
                 'lbs_weights', 'j_regressor_extra'):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    assert tuple(ta.parents) == tuple(int(p) for p in ja.parents)
    assert tuple(ta.extra_vertex_ids) == tuple(
        int(i) for i in ja.extra_vertex_ids)


@pytest.mark.parametrize('stage1,jax_stage1', [('module', 'flax'),
                                               ('fused', 'fused')])
def test_pipeline_matches_bench(inputs, jax_runs, stage1, jax_stage1):
    """Angles 1e-4 rad, vertices 5e-3 m, joints2d 0.1 px, cam_t rtol and
    atol 2e-3: the slice's tolerances (tests/test_torch_serving.py)."""
    _, raw, corners, center, scale = inputs
    cc_vars, spec_vars = jax_runs['vars']
    _, _, assets, pipeline = build_pipeline(
        compute_dtype=torch.float32, img_res=IMG_RES, stage1=stage1,
        device='cpu',
        camcalib_state=state_dict_from_flax(cc_vars, 'camcalib',
                                            'resnet50'),
        spec_state=state_dict_from_flax(spec_vars, 'hmr', 'resnet50'))
    assert assets.packed_lbs is not None
    launches = (TB.LAUNCHES, TL.LAUNCHES)
    out = pipeline(torch.from_numpy(raw), torch.from_numpy(corners),
                   torch.from_numpy(center), torch.from_numpy(scale))
    assert (TB.LAUNCHES, TL.LAUNCHES) == launches    # CPU: plain versions
    verts, j2d, cam_t, vfov, pitch, roll = (o.numpy() for o in out)
    ref = jax_runs[jax_stage1]
    assert verts.shape == (FRAMES, 6890, 3) and j2d.shape == (FRAMES, 49, 2)
    for o in (verts, j2d, cam_t, vfov, pitch, roll):
        assert np.isfinite(o).all()
    for got, want in zip((vfov, pitch, roll), ref[3:]):
        assert np.ptp(want) > 1e-3          # the frames' angles differ
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(verts, ref[0], atol=5e-3)
    np.testing.assert_allclose(j2d, ref[1], atol=0.1)
    np.testing.assert_allclose(cam_t, ref[2], rtol=2e-3, atol=2e-3)


def test_unknown_stage1_raises():
    with pytest.raises(ValueError, match='stage1'):
        build_pipeline(stage1='flax', device='cpu')
