"""The spec_eval golden computed with the port: CamDataset -> DataLoader
-> evaluate_dataset -> compute_error on tests/test_goldens.py's synthetic
eval fixture, with the golden's PRNGKey(0) ResNet-18 HMR carried over by
the weight bridge, against the frozen numbers of tests/goldens.json
(``spec_eval``) at the goldens' RTOL 2e-3 and ATOL 1e-5.

The JAX package's own golden test is marked slow; this one compares
against the frozen numbers only, so it runs in tier-1.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.models import HMR as JaxHMR
from tests.test_goldens import (
    ATOL,
    GOLDENS_PATH,
    RTOL,
    _assert_close,
    _write_eval_fixture,
)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden_weights():
    """The golden's HMR variables (tests/test_goldens.py's init) as a
    state_dict of the port's HMR."""
    from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

    model = JaxHMR(backbone='resnet18', use_cam=True, use_cam_feats=False)
    eye = jnp.tile(jnp.eye(3), (1, 1, 1))
    variables = model.init(
        jax.random.PRNGKey(0), JS.create_test_assets(),
        jnp.zeros((1, 224, 224, 3)), eye, eye, jnp.ones((1,)),
        jnp.ones((1, 2)), jnp.ones((1,)), jnp.ones((1,)))
    return state_dict_from_flax(variables, 'hmr', 'resnet18')


def test_spec_eval_golden(tmp_path):
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.data.cam_dataset import CamDataset
    from spec_tpu_torch.data.loader import DataLoader
    from spec_tpu_torch.eval.eval_loop import evaluate_dataset
    from spec_tpu_torch.eval.evaluator import compute_error
    from spec_tpu_torch.models.hmr import HMR

    annot, img_dir = _write_eval_fixture(str(tmp_path))
    assets = S.create_test_assets()
    jreg = assets.j_regressor_h36m.numpy()
    model = HMR(backbone='resnet18', use_cam=True, use_cam_feats=False)
    ds = CamDataset(annot, img_dir, dataset='3dpw-test-cam',
                    is_train=False, img_res=224)
    loader = DataLoader(ds, batch_size=2, num_workers=1)
    summary, acc = evaluate_dataset(
        model, golden_weights(), loader, {'neutral': assets}, jreg,
        use_gt_cam=True, use_gender=False, save_results=True,
        save_images=False, save_freq=1, logdir=str(tmp_path),
        dataset_name='3dpw-test-cam')
    assert (tmp_path / 'evaluation_results_3dpw-test-cam.pkl').exists()

    res = acc.results_dict()
    headline = compute_error(
        '3dpw-test-cam',
        pred_vertices=np.asarray(res['vertices'], np.float32),
        pred_cam_rotmat=np.tile(np.eye(3, dtype='f4'),
                                (len(res['vertices']), 1, 1)),
        gt_pose=ds.pose, gt_betas=ds.betas, assets=assets,
        j_regressor_h36m=jreg, gt_pose_cam=ds.pose_cam,
        gt_cam_rotmat=None, device='cpu')
    out = {k: float(v) for k, v in summary.items() if np.isfinite(v)}
    out.update({f'headline_{k}': float(v) for k, v in headline.items()
                if k != 'protocol'})
    with open(GOLDENS_PATH) as f:
        golden = json.load(f)['spec_eval']
    _assert_close(golden, out, 'spec_eval', rtol=RTOL, atol=ATOL)
