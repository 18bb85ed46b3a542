"""spec_tpu_torch.models vs spec_tpu.models with the same weights.

JAX variables are initialized with PRNGKey(0) and carried into the port
by the weight bridge ``state_dict_from_flax``; both run fp32 on the CPU.
Also: a lightning-dialect torch checkpoint round-trips through the port
loader and through the JAX loader + bridge unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.models import HMR as JaxHMR
from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib
from spec_tpu.models.backbones import get_backbone as jax_backbone
from spec_tpu_torch.models.backbones.resnet import get_backbone
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.models.heads.smpl_head import smpl_cam_head
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.utils.checkpoints import (
    assets_from_jax,
    hmr_state_dict,
    load_torch_state_dict,
    select_state_dict,
    state_dict_from_flax,
)

V_SMALL = 700   # synthetic SMPL size; extra-joint vertex ids wrap mod V


def _load(model, variables, kind, backbone):
    model.load_state_dict(state_dict_from_flax(variables, kind, backbone))
    return model.eval()


@pytest.mark.parametrize('arch', ['resnet18', 'resnet50'])
def test_resnet_trunk_matches_jax(rng, arch):
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jmodel = jax_backbone(arch)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))   # NHWC
    port = _load(get_backbone(arch), variables, 'resnet', arch)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(out.transpose(0, 2, 3, 1), ref,
                               rtol=1e-4, atol=1e-4)


def test_camcalib_logits_match_jax(rng):
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    jmodel = JaxCamCalib(backbone='resnet18')
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jmodel.apply(variables, jnp.asarray(x))
    port = _load(CameraRegressorNetwork(backbone='resnet18'), variables,
                 'camcalib', 'resnet18')
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for o, r in zip(out, ref):
        assert o.shape == (2, 256)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4)


def _hmr_inputs(rng, B=3, res=64):
    from spec_tpu.core.geometry import build_cam_intrinsics, euler_to_rotmat

    crops = rng.randn(B, res, res, 3).astype(np.float32)
    rot = np.array(euler_to_rotmat(jnp.asarray(
        np.stack([rng.randn(B) * 0.2, np.zeros(B), rng.randn(B) * 0.1],
                 1).astype(np.float32))))
    w = np.full(B, 320.0, np.float32)
    h = np.full(B, 240.0, np.float32)
    K = np.array(build_cam_intrinsics(
        jnp.asarray((rng.rand(B) * 200 + 250).astype(np.float32)),
        jnp.asarray(w), jnp.asarray(h)))
    scale = (rng.rand(B) * 0.5 + 0.4).astype(np.float32)
    center = (rng.rand(B, 2) * 150 + 60).astype(np.float32)
    return crops, rot, K, scale, center, w, h


@pytest.mark.parametrize('use_cam_feats', [True, False])
def test_hmr_matches_jax(rng, use_cam_feats):
    args = _hmr_inputs(rng)
    jassets = JS.create_test_assets(num_vertices=V_SMALL)
    jmodel = JaxHMR(backbone='resnet18', use_cam=True,
                    use_cam_feats=use_cam_feats, img_res=64)
    jargs = [jnp.asarray(a) for a in args]
    variables = jmodel.init(jax.random.PRNGKey(0), jassets, *jargs)
    ref = {k: np.asarray(v)
           for k, v in jmodel.apply(variables, jassets, *jargs).items()}

    port = _load(HMR(backbone='resnet18', use_cam_feats=use_cam_feats,
                     img_res=64), variables, 'hmr', 'resnet18')
    tassets = assets_from_jax(jassets)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port(tassets, *targs).items()}
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)

    # SMPL after the head: the JAX head's own outputs through the port's
    # SMPL camera head hold the 1e-5 m vertex budget.
    with torch.no_grad():
        smpl = smpl_cam_head(
            tassets, torch.from_numpy(ref['pred_pose']),
            torch.from_numpy(ref['pred_shape']),
            torch.from_numpy(ref['pred_cam']), targs[1], targs[2],
            targs[3], targs[4], targs[5], targs[6], crop_res=64)
    np.testing.assert_allclose(smpl['smpl_vertices'].numpy(),
                               ref['smpl_vertices'], atol=1e-5)
    np.testing.assert_allclose(smpl['smpl_joints3d'].numpy(),
                               ref['smpl_joints3d'], atol=1e-5)


def _roundtrip(tmp_path, model, port_select, jax_load, kind):
    """Lightning checkpoint of ``model`` -> port loader and JAX loader +
    bridge; both must give back the original state_dict."""
    model.reset_parameters(torch.Generator().manual_seed(7))
    original = model.state_dict()
    path = tmp_path / f'{kind}.ckpt'
    torch.save({'state_dict': {'model.' + k: v for k, v in original.items()},
                'epoch': 3}, path)

    via_port = port_select(load_torch_state_dict(str(path)), model)
    via_jax = state_dict_from_flax(jax_load(str(path), backbone='resnet18'),
                                   kind, 'resnet18')
    for got in (via_port, via_jax):
        assert set(got) == set(original)
        for k, v in original.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    model.load_state_dict(via_jax)   # strict: every key present


def test_hmr_checkpoint_roundtrip(tmp_path):
    from spec_tpu.utils.checkpoints import load_spec_variables

    _roundtrip(tmp_path, HMR(backbone='resnet18', use_cam_feats=True),
               hmr_state_dict, load_spec_variables, 'hmr')


def test_camcalib_checkpoint_roundtrip(tmp_path):
    from spec_tpu.utils.checkpoints import load_camcalib_variables

    _roundtrip(tmp_path, CameraRegressorNetwork(backbone='resnet18'),
               select_state_dict, load_camcalib_variables, 'camcalib')


def test_spin_dialect_without_init_buffers(tmp_path):
    """SPIN checkpoints keep the HMR flat (no backbone./head. prefixes)
    and may lack the init buffers: both are filled in as the JAX
    converter fills them."""
    model = HMR(backbone='resnet18')
    model.reset_parameters(torch.Generator().manual_seed(3))
    flat = {}
    for k, v in model.state_dict().items():
        if k.startswith('head.init_'):
            continue
        flat[k.split('.', 1)[1]] = v
    path = tmp_path / 'spin.pt'
    torch.save({'model': flat}, path)
    sd = hmr_state_dict(load_torch_state_dict(str(path)), model)
    torch.testing.assert_close(sd['head.init_cam'],
                               torch.tensor([[0.9, 0.0, 0.0]]))
    torch.testing.assert_close(sd['backbone.conv1.weight'],
                               model.state_dict()['backbone.conv1.weight'])
