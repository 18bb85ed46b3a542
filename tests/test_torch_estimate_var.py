"""The HMR head's ``estimate_var`` branch against spec_tpu's, on the CPU.

The JAX head (``HMRHead(estimate_var=True)``) is initialized on
pre-pooled ResNet-18 features (512 wide); its weights reach the port's
head through ``state_dict_from_flax`` (inside a ResNet-18 HMR tree), so
the bridge is held to carry ``decpose_var`` and ``decshape_var``. Every
output, the log-variances among them, within 1e-5 absolute (fp32, eval
mode), and ``smpl_param_loss_uncertainty`` on each side's outputs
within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.losses.hmr import smpl_param_loss_uncertainty as jax_nll
from spec_tpu.models import HMR as JaxHMR
from spec_tpu.models.heads.hmr_head import HMRHead as JaxHead
from spec_tpu_torch.losses.hmr import smpl_param_loss_uncertainty
from spec_tpu_torch.models.heads.hmr_head import HMRHead
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

ATOL, LOSS_RTOL = 1e-5, 1e-5
B, C = 3, 512


@pytest.mark.parametrize('use_cam_feats', [False, True])
def test_estimate_var_head_matches_jax(use_cam_feats):
    rng = np.random.RandomState(0)
    feats = rng.randn(B, C).astype('f4')
    rot = np.tile(np.eye(3, dtype='f4'), (B, 1, 1))
    vfov = np.full((B,), 0.8, 'f4')
    cam = (dict(cam_rotmat=jnp.asarray(rot), cam_vfov=jnp.asarray(vfov))
           if use_cam_feats else {})
    jhead = JaxHead(use_cam_feats=use_cam_feats, estimate_var=True)
    hv = jhead.init(jax.random.PRNGKey(0), jnp.asarray(feats), **cam)
    want = jhead.apply(hv, jnp.asarray(feats), **cam)
    assert {'pred_pose_logvar', 'pred_shape_logvar'} <= set(want)

    # the head's params inside a whole HMR tree, through the bridge
    tree = JaxHMR(backbone='resnet18', use_cam_feats=use_cam_feats).init(
        jax.random.PRNGKey(1), *_hmr_args(use_cam_feats))
    tree = jax.device_get(tree)
    tree['params'] = dict(tree['params'], head=jax.device_get(hv['params']))
    sd = state_dict_from_flax(tree, 'hmr', 'resnet18')
    assert 'head.decpose_var.weight' in sd and 'head.decshape_var.bias' in sd
    model = HMR(backbone='resnet18', use_cam_feats=use_cam_feats)
    model.head = HMRHead(C, use_cam_feats=use_cam_feats, estimate_var=True)
    model.load_state_dict(sd)
    head = model.head.eval()
    tcam = (dict(cam_rotmat=torch.from_numpy(rot),
                 cam_vfov=torch.from_numpy(vfov)) if use_cam_feats else {})
    with torch.no_grad():
        got = head(torch.from_numpy(feats), **tcam)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=k)
    assert got['pred_pose_logvar'].shape == (B, 144)
    assert got['pred_shape_logvar'].shape == (B, 10)

    gt_pose = rng.randn(B, 72).astype('f4') * 0.2
    gt_betas = rng.randn(B, 10).astype('f4')
    has = np.array([1.0, 0.0, 1.0], 'f4')
    w_pose, w_betas = jax_nll(
        want['pred_pose_6d'], want['pred_pose_logvar'], want['pred_shape'],
        want['pred_shape_logvar'], jnp.asarray(gt_pose),
        jnp.asarray(gt_betas), jnp.asarray(has))
    g_pose, g_betas = smpl_param_loss_uncertainty(
        got['pred_pose_6d'], got['pred_pose_logvar'], got['pred_shape'],
        got['pred_shape_logvar'], torch.from_numpy(gt_pose),
        torch.from_numpy(gt_betas), torch.from_numpy(has))
    np.testing.assert_allclose(float(g_pose), float(w_pose), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(g_betas), float(w_betas),
                               rtol=LOSS_RTOL)


def _hmr_args(use_cam_feats):
    from spec_tpu.core import smpl as JS

    Bh = 1
    eye = jnp.tile(jnp.eye(3), (Bh, 1, 1))
    one = jnp.ones((Bh,))
    return (JS.create_test_assets(num_vertices=64),
            jnp.zeros((Bh, 64, 64, 3)), eye,
            jnp.tile(jnp.array([[500.0, 0, 32], [0, 500.0, 32],
                                [0, 0, 1]]), (Bh, 1, 1)),
            one, jnp.ones((Bh, 2)), one * 64, one * 64)


def test_estimate_var_is_off_by_default_and_trains():
    """Without ``estimate_var`` the head has no variance linears and no
    log-variance outputs; with it, both linears get gradients and the
    random init covers them."""
    plain = HMRHead(C)
    assert not hasattr(plain, 'decpose_var')
    assert 'pred_pose_logvar' not in plain.eval()(torch.zeros(2, C))
    head = HMRHead(C, estimate_var=True)
    head.reset_parameters(torch.Generator().manual_seed(0))
    assert head.decpose_var.weight.abs().sum() > 0
    out = head.train()(torch.randn(2, C),
                       generator=torch.Generator().manual_seed(1))
    (out['pred_pose_logvar'].sum() + out['pred_shape_logvar'].sum()
     ).backward()
    assert head.decpose_var.weight.grad.abs().sum() > 0
    assert head.decshape_var.bias.grad.abs().sum() > 0
