"""spec_tpu_torch.core.smpl vs spec_tpu.core.smpl: the SMPL forward
(fused and plain vertex paths), the loud missing-regressor error, and the
chumpy-tolerant asset loader. CPU, fp32; on the CPU the port's fused path
runs the kernel's plain twin, the JAX one runs Pallas in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.core.geometry import rodrigues
from spec_tpu_torch.core import smpl as TS
from spec_tpu_torch.utils.checkpoints import assets_from_jax
from tests.test_smpl import write_synthetic_smpl_pkl


@pytest.fixture(scope='module')
def full_assets():
    return JS.create_test_assets(), TS.create_test_assets()


def test_synthetic_assets_identical(full_assets):
    """Same RandomState sequence -> identical synthetic assets, and the
    assets bridge reproduces them."""
    jax_assets, port_assets = full_assets
    bridged = assets_from_jax(jax_assets)
    for f in dataclasses.fields(TS.SMPLAssets):
        if f.name == 'packed_lbs':
            continue
        ref = getattr(jax_assets, f.name)
        for port in (getattr(port_assets, f.name), getattr(bridged, f.name)):
            if isinstance(ref, tuple):
                assert port == ref, f.name
            else:
                np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                              err_msg=f.name)


@pytest.mark.parametrize('fused', [False, True])
def test_smpl_forward_spin49_matches_jax(rng, full_assets, fused):
    jax_assets, port_assets = full_assets
    B = 2
    betas = rng.randn(B, 10).astype('f4') * 0.5
    body = rng.randn(B, 23, 3).astype('f4') * 0.3
    glob = rng.randn(B, 1, 3).astype('f4') * 0.3
    transl = rng.randn(B, 3).astype('f4')
    if fused:
        port_assets = TS.with_packed_lbs(port_assets)
        # The Pallas kernel needs interpret mode on the CPU.
        rot = rodrigues(jnp.concatenate([jnp.asarray(glob),
                                         jnp.asarray(body)], 1))
        ref_verts = JS.lbs_fused(jax_assets, jnp.asarray(betas), rot,
                                 interpret=True)[0]
    ref = JS.smpl_forward(
        jax_assets, jnp.asarray(betas), jnp.asarray(body), jnp.asarray(glob),
        transl=jnp.asarray(transl), joint_set='spin49')
    out = TS.smpl_forward(
        port_assets, torch.from_numpy(betas), torch.from_numpy(body),
        torch.from_numpy(glob), transl=torch.from_numpy(transl),
        joint_set='spin49')
    assert out.joints.shape == (B, 49, 3)
    np.testing.assert_allclose(out.vertices.numpy(), np.asarray(ref.vertices),
                               atol=1e-5)
    np.testing.assert_allclose(out.joints.numpy(), np.asarray(ref.joints),
                               atol=1e-5)
    np.testing.assert_allclose(out.joints_native.numpy(),
                               np.asarray(ref.joints_native), atol=1e-5)
    np.testing.assert_allclose(out.global_transforms.numpy(),
                               np.asarray(ref.global_transforms), atol=2e-6)
    if fused:
        np.testing.assert_allclose(
            out.vertices.numpy() - transl[:, None],
            np.asarray(ref_verts), atol=1e-5)


@pytest.mark.parametrize('joint_set', ['native', 'smpl54'])
def test_smpl_forward_rotmat_input_other_joint_sets(rng, joint_set):
    jax_assets = JS.create_test_assets(num_vertices=500)
    port_assets = TS.create_test_assets(num_vertices=500)
    rot = np.array(rodrigues(jnp.asarray(
        rng.randn(3, 24, 3).astype('f4') * 0.4)))
    betas = rng.randn(3, 10).astype('f4')
    ref = JS.smpl_forward(jax_assets, jnp.asarray(betas),
                          jnp.asarray(rot[:, 1:]), jnp.asarray(rot[:, :1]),
                          pose2rot=False, joint_set=joint_set)
    out = TS.smpl_forward(port_assets, torch.from_numpy(betas),
                          torch.from_numpy(rot[:, 1:]),
                          torch.from_numpy(rot[:, :1]), pose2rot=False,
                          joint_set=joint_set)
    np.testing.assert_allclose(out.joints.numpy(), np.asarray(ref.joints),
                               atol=1e-5)
    np.testing.assert_allclose(out.vertices.numpy(),
                               np.asarray(ref.vertices), atol=1e-5)


@pytest.mark.parametrize('missing', ['j_regressor_extra', 'extra_vertex_ids'])
def test_missing_regressor_raises(missing):
    assets = dataclasses.replace(TS.create_test_assets(num_vertices=64),
                                 **{missing: None})
    z = torch.zeros(1, 23, 3)
    with pytest.raises(ValueError, match=missing):
        TS.smpl_forward(assets, torch.zeros(1, 10), z, torch.zeros(1, 1, 3),
                        joint_set='spin49')


def test_loader_reads_chumpy_pkl_like_jax(tmp_path):
    raw = write_synthetic_smpl_pkl(tmp_path / 'SMPL_NEUTRAL.pkl',
                                   num_vertices=300)
    rng = np.random.RandomState(3)
    jre = rng.rand(9, 300).astype(np.float32)
    np.save(tmp_path / 'jre.npy', jre)
    kwargs = dict(gender='neutral',
                  j_regressor_extra_path=str(tmp_path / 'jre.npy'))
    ref = JS.load_smpl_assets(str(tmp_path), **kwargs)
    port = TS.load_smpl_assets(str(tmp_path), **kwargs)
    assert port.num_vertices == raw['v_template'].shape[0] == 300
    for name in ('v_template', 'shapedirs', 'posedirs', 'j_regressor',
                 'lbs_weights', 'faces', 'j_regressor_extra'):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert port.parents == ref.parents
    assert port.extra_vertex_ids == ref.extra_vertex_ids
