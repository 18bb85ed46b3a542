"""spec_tpu_torch.models.backbones.hrnet against
spec_tpu.models.backbones.hrnet on the CPU, fp32, 64² inputs (as
``tests/test_hrnet.py``).

* The W32 trunk with the ``-interp`` and the ``-conv`` head against the
  JAX trunk through ``state_dict_from_flax(kind='hrnet')``, with
  BatchNorm statistics drawn centred (flax's init leaves mean 0 and
  var 1, which would hide the eval-mode normalization): within atol
  2e-3 and rtol 1e-3, the reference's budget against an independent
  torch HRNet (``tests/test_hrnet.py``). Measured: 2.3e-3 (interp) and
  2.6e-3 (conv) absolute on outputs of magnitude ~3e3, about 1e-6 of
  the largest.
* W48's width (720) and both heads' shapes; the port's parameter names
  are the official HRNet's: the reference's ``convert_torch_hrnet_params``
  reads the port's state_dict, and the bridge gives it back unchanged.
* ``HMR(backbone='hrnet_w32-conv')`` against the JAX HMR: vertices
  within 1e-4 m; an HMR checkpoint with an HRNet trunk loads as the
  reference's ``convert_torch_hmr_params`` loads it.
* REMAT on HRNet (each exchange module checkpointed) equals the plain
  trunk: loss, gradients and BatchNorm running statistics, bit for bit.
* The stage bodies a card captures with HMR-HRNet (the predictor's
  stage 2, the train step with REMAT) are capturable.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.models import HMR as JaxHMR
from spec_tpu.models import backbones as JB
from spec_tpu.models.backbones.hrnet import convert_torch_hrnet_params
from spec_tpu_torch.models import backbones as TB
from spec_tpu_torch.models.backbones import resnet as R
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.utils.checkpoints import (
    assets_from_jax,
    hmr_state_dict,
    load_torch_state_dict,
    state_dict_from_flax,
)
from tests.test_torch_models import _hmr_inputs

ATOL, RTOL = 2e-3, 1e-3          # tests/test_hrnet.py's budget


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: these tests run many small operations, and
    under a parallel test run (several workers sharing the cores) every
    parallel region's barrier waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _centred_stats(variables, seed=0):
    """The variables with BatchNorm statistics drawn as trained ones
    look: means N(0, 0.1), variances U(0.75, 1.25)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == 'mean':
            return jnp.asarray(rng.randn(*shape).astype('f4') * 0.1)
        return jnp.asarray(rng.rand(*shape).astype('f4') * 0.5 + 0.75)

    stats = jax.tree_util.tree_map_with_path(draw,
                                             variables['batch_stats'])
    return {'params': variables['params'], 'batch_stats': stats}


@pytest.fixture(scope='module')
def x64():
    return np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize('head', ['interp', 'conv'])
def test_hrnet_w32_trunk_matches_jax(x64, head):
    name = f'hrnet_w32-{head}'
    jmodel = JB.get_backbone(name)
    variables = _centred_stats(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x64)))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x64)))   # NHWC
    port = TB.get_backbone(name)
    port.load_state_dict(state_dict_from_flax(variables, 'hrnet', name))
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x64).permute(0, 3, 1, 2))
    out = out.permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 2, 2, 480)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('name', ['hrnet_w32-interp', 'hrnet_w32-conv',
                                  'hrnet_w48-interp', 'hrnet_w48-conv'])
def test_trunk_width_shape_and_official_names(name):
    arch = name.split('-')[0]
    width = {'hrnet_w32': 480, 'hrnet_w48': 720}[arch]
    port = TB.get_backbone(name)
    assert port.out_channels == width == TB.get_backbone_info(name)[
        'n_output_channels'] == JB.get_backbone_info(name)[
        'n_output_channels']
    port.reset_parameters(torch.Generator().manual_seed(1))
    port.eval()
    with torch.no_grad():
        assert port(torch.zeros(1, 3, 64, 96)).shape == (1, width, 2, 3)
    # The reference's converter reads the official names; the bridge
    # returns them. Only the -conv head (PARE's) is not official.
    sd = port.state_dict()
    variables = convert_torch_hrnet_params(
        {k: v.numpy() for k, v in sd.items()}, arch=arch)
    back = state_dict_from_flax(variables, 'hrnet', arch)
    official = {k for k in sd if not k.startswith('downsample_stage_')}
    assert set(back) == official
    assert (name.endswith('-conv')) == (len(official) < len(sd))
    for k in official:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope='module')
def hmr_pair():
    rng = np.random.RandomState(42)
    args = _hmr_inputs(rng, B=2)
    jassets = JS.create_test_assets(num_vertices=700)
    jmodel = JaxHMR(backbone='hrnet_w32-conv', use_cam=True,
                    use_cam_feats=True, img_res=64)
    jargs = [jnp.asarray(a) for a in args]
    variables = _centred_stats(
        jmodel.init(jax.random.PRNGKey(0), jassets, *jargs))
    ref = {k: np.asarray(v)
           for k, v in jmodel.apply(variables, jassets, *jargs).items()}
    port = HMR(backbone='hrnet_w32-conv', use_cam_feats=True, img_res=64)
    port.load_state_dict(state_dict_from_flax(variables, 'hmr',
                                              'hrnet_w32-conv'))
    return port.eval(), assets_from_jax(jassets), args, ref


def test_hmr_hrnet_matches_jax(hmr_pair):
    port, tassets, args, ref = hmr_pair
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port(
            tassets, *[torch.from_numpy(a) for a in args]).items()}
    assert set(out) == set(ref)
    np.testing.assert_allclose(out['smpl_vertices'], ref['smpl_vertices'],
                               atol=1e-4)
    for k in ('pred_pose', 'pred_shape', 'pred_cam', 'smpl_joints3d'):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)


def test_hmr_hrnet_checkpoint_loads_as_the_reference(hmr_pair, tmp_path):
    """A lightning checkpoint of the HRNet HMR: the port's loader gives
    it back; the reference's converter + the bridge give back its
    official trunk and head. Without the -conv head (an official trunk)
    the port keeps the model's own head weights."""
    from spec_tpu.models.hmr import convert_torch_hmr_params

    port = hmr_pair[0]
    original = port.state_dict()
    path = tmp_path / 'hmr_hrnet.ckpt'
    torch.save({'state_dict': {'model.' + k: v for k, v in original.items()}},
               path)
    flat = load_torch_state_dict(str(path))
    fresh = HMR(backbone='hrnet_w32-conv', use_cam_feats=True, img_res=64)
    got = hmr_state_dict(flat, fresh)
    for k, v in original.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    via_jax = state_dict_from_flax(
        convert_torch_hmr_params(flat, backbone='hrnet_w32-conv'), 'hmr',
        'hrnet_w32-conv')
    head = [k for k in original if k.startswith('backbone.downsample_')]
    assert head and set(via_jax) == set(original) - set(head)
    for k, v in via_jax.items():
        torch.testing.assert_close(v, original[k], rtol=0, atol=0, msg=k)
    trunk_only = {k: v for k, v in flat.items()
                  if not k.startswith('backbone.downsample_')}
    kept = hmr_state_dict(trunk_only, fresh)
    for k in head:
        torch.testing.assert_close(kept[k], fresh.state_dict()[k], rtol=0,
                                   atol=0, msg=k)


def _trunk_step(remat, x):
    m = TB.get_backbone('hrnet_w32-conv', remat=remat)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.train()
    loss = (m(x).float() ** 2).mean()
    loss.backward()
    return (loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()},
            {k: v.clone() for k, v in m.state_dict().items()})


def test_remat_hrnet_is_the_same_step(monkeypatch):
    """Each exchange module recomputed in the backward, its BatchNorms
    marked (resnet._Recompute): the same step as without remat,
    statistics included, one batch counted."""
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 64, 64).astype('f4'))
    l0, g0, s0 = _trunk_step(False, x)
    seen = []
    real = R.BatchNorm2d.forward

    def spy(self, inp):
        seen.append(self.recomputing)
        return real(self, inp)

    monkeypatch.setattr(R.BatchNorm2d, 'forward', spy)
    l1, g1, s1 = _trunk_step(True, x)
    assert any(seen), 'the backward recomputed no module'
    assert l0 == l1
    assert g0.keys() == g1.keys() and s0.keys() == s1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert int(s1['stage4.0.branches.0.0.bn1.num_batches_tracked']) == 1


def test_hmr_remat_reaches_the_hrnet_trunk():
    model = HMR(backbone='hrnet_w48-interp', remat=True)
    assert model.backbone.remat and model.backbone.out_channels == 720
    assert model.head.fc1.in_features == 720 + 157    # features + params


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_hmr_hrnet_predict_stage_is_capturable(hmr_pair, dtype):
    """The predictor's stage 2 over HMR-HRNet (``serving._spec_forward``)
    uploads nothing, syncs nothing and takes no data-dependent shape
    after a warm-up (tests/test_torch_graphs.py's check)."""
    from spec_tpu_torch.serving import _spec_forward
    from tests.test_torch_graphs import _uncapturable_ops

    port, tassets, args, _ = hmr_pair
    model = HMR(backbone='hrnet_w32-conv', use_cam_feats=True, img_res=64,
                dtype=dtype)
    model.load_state_dict(port.state_dict())
    model.eval()
    with torch.inference_mode():
        seen = _uncapturable_ops(functools.partial(_spec_forward, model,
                                                   tassets),
                                 *[torch.from_numpy(a) for a in args])
    assert not seen, seen


def test_hrnet_remat_train_step_is_capturable():
    """The SPEC train step with HMR-HRNet and REMAT (the step body a
    CUDA graph captures on the card)."""
    import __graft_entry__ as ge
    from spec_tpu_torch.core.smpl import create_test_assets
    from spec_tpu_torch.train import (
        adam,
        create_train_state,
        make_spec_train_step,
    )
    from tests.test_torch_graphs import _uncapturable_ops

    rng = np.random.RandomState(0)
    args = ge._example_inputs(2, 64, rng)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in ge._example_batch(2, rng, args).items()}
    model = HMR(backbone='hrnet_w32-conv', use_cam_feats=True, remat=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train()
    state = create_train_state(model, adam(1e-4))
    step = make_spec_train_step(model, create_test_assets(num_vertices=128))
    step._bind(state)
    names = step.keys(batch)
    body = functools.partial(step._body, update=True, generator=None,
                             names=names)
    seen = _uncapturable_ops(body, *[batch[k] for k in names])
    assert not seen, seen


@pytest.mark.parametrize('cli', ['spec_train', 'spec_eval'])
def test_cli_models_take_an_hrnet_config(cli, tmp_path):
    """spec_train and spec_eval build HMR-HRNet from a config naming it
    (with TRAINING.REMAT, the trainer's checkpoints each module)."""
    import importlib

    from spec_tpu_torch.utils.config import update_hparams

    cfg_file = tmp_path / 'hrnet.yaml'
    cfg_file.write_text('HMR:\n  BACKBONE: hrnet_w32-conv\n'
                        'TRAINING:\n  REMAT: true\n')
    cfg = update_hparams(str(cfg_file))
    mod = importlib.import_module(f'spec_tpu_torch.cli.{cli}')
    model = mod.build_model(cfg, '', torch.device('cpu'))
    assert type(model.backbone).__name__ == 'HRNet'
    assert model.backbone.out_channels == 480
    assert model.backbone.remat == (cli == 'spec_train')
    assert model.training == (cli == 'spec_train')


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_bench_runs_an_hrnet_backbone(mode, capsys):
    import json

    from spec_tpu_torch import bench

    assert bench.main(['--mode', mode, '--batch', '2', '--frame_h', '64',
                       '--backbone', 'hrnet_w32-conv', '--device', 'cpu',
                       '--iters', '1']) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 'hrnet_w32-conv' in result['metric'] and result['value'] > 0
