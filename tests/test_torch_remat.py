"""TRAINING.REMAT in spec_tpu_torch (each backbone block under
``torch.utils.checkpoint``) on the CPU.

* The port against itself: a ResNet with and without ``remat`` gives
  the same train-mode loss, gradients and BatchNorm running statistics
  after a step, bit for bit (the reference's
  ``test_backbone_remat_equivalence``, whose flax ``nn.remat`` is held
  the same way). A checkpointed block runs its forward again in the
  backward; the statistics must take one momentum update, not two, and
  ``num_batches_tracked`` counts one batch.
* The port against spec_tpu: the SPEC train step with ``remat`` on both
  sides (``HMR(remat=True)``), ResNet-18 at the ``train_steps`` golden's
  setup, three steps of ``adam(1e-5)``, dropout off: the limits of
  ``tests/test_torch_train_step.py`` (losses 1e-4 relative, the model
  1e-4 relative, its update 3e-4, each tensor's update 0.2).
* The step with ``remat`` is capturable, the trainer takes a model built
  as TRAINING.REMAT says and refuses one built otherwise.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from spec_tpu.core import smpl as JS
from spec_tpu.models import HMR as JaxHMR
from spec_tpu.train import adam as jax_adam
from spec_tpu.train import create_train_state as jax_create_train_state
from spec_tpu.train import make_spec_train_step as jax_spec_step
from spec_tpu_torch.models.backbones import resnet as R
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.train import (
    adam,
    create_train_state,
    make_spec_train_step,
)
from spec_tpu_torch.utils.checkpoints import (
    assets_from_jax,
    state_dict_from_flax,
)
from tests.test_torch_train_step import (
    _hold_losses,
    _hold_params,
    _jax_state_dict,
    _no_dropout,
)

LR = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trunk_step(backbone, remat, x):
    m = R.get_backbone(backbone, remat=remat)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.train()
    loss = (m(x).float() ** 2).sum()
    loss.backward()
    return (loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()},
            {k: v.clone() for k, v in m.state_dict().items()})


@pytest.mark.parametrize('backbone', ['resnet18', 'resnet50'])
def test_remat_trunk_is_the_same_step(backbone):
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 64, 64).astype('f4'))
    l0, g0, s0 = _trunk_step(backbone, False, x)
    l1, g1, s1 = _trunk_step(backbone, True, x)
    assert l0 == l1
    assert g0.keys() == g1.keys() and s0.keys() == s1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert int(s1['bn1.num_batches_tracked']) == 1
    assert int(s1['layer1.0.bn1.num_batches_tracked']) == 1


def test_remat_recompute_leaves_the_statistics_alone(monkeypatch):
    """The backward recomputes the blocks with their BatchNorms marked,
    and the statistics take one update: without the mark the recompute
    would move them a second time."""
    x = torch.randn(2, 3, 32, 32)
    m = R.get_backbone('resnet18', remat=True).train()
    seen = []
    real = R.BatchNorm2d.forward

    def spy(self, inp):
        seen.append(self.recomputing)
        return real(self, inp)

    monkeypatch.setattr(R.BatchNorm2d, 'forward', spy)
    before = m.layer1[0].bn1.num_batches_tracked.clone()
    (m(x) ** 2).sum().backward()
    calls = [s for s in seen if s]
    assert calls, 'the backward recomputed no block'
    assert int(m.layer1[0].bn1.num_batches_tracked - before) == 1
    assert not any(getattr(mod, 'recomputing', False)
                   for mod in m.modules())
    # no grad: the blocks run plainly
    seen.clear()
    with torch.no_grad():
        m(x)
    assert seen and not any(seen)


def _remat_setup():
    rng = np.random.RandomState(0)
    jassets = JS.create_test_assets(num_vertices=128)
    jmodel = JaxHMR(backbone='resnet18', use_cam=True, use_cam_feats=True,
                    remat=True)
    args = ge._example_inputs(4, 64, rng)
    variables = jmodel.init(jax.random.PRNGKey(0), jassets, *args)
    jbatch = ge._example_batch(4, rng, args)
    port = HMR(backbone='resnet18', use_cam_feats=True, remat=True)
    port.load_state_dict(state_dict_from_flax(variables, 'hmr', 'resnet18'))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jmodel, variables, jassets, jbatch, port, \
        assets_from_jax(jassets), tbatch


def test_remat_train_step_matches_jax(monkeypatch):
    _no_dropout(monkeypatch)
    jmodel, variables, jassets, jbatch, port, tassets, tbatch = \
        _remat_setup()
    port.head.dropout_rate = 0.0
    tx = jax_adam(LR)
    jstate = jax_create_train_state(variables, tx)
    jstep = jax.jit(jax_spec_step(jmodel, jassets, tx))
    state = create_train_state(port, adam(LR))
    step = make_spec_train_step(port, tassets)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    key = jax.random.PRNGKey(1)
    for i in range(3):
        jstate, jl = jstep(jstate, jbatch, key)
        state, tl = step(state, tbatch)
        _hold_losses(tl, jl)
        _hold_params(port.state_dict(), _jax_state_dict(jstate), start, i)
    assert int(port.state_dict()[
        'backbone.layer2.0.bn1.num_batches_tracked']) == 3


def test_remat_train_step_is_capturable():
    from tests.test_torch_graphs import _uncapturable_ops

    *_, port, tassets, tbatch = _remat_setup()
    state = create_train_state(port, adam(1e-4))
    step = make_spec_train_step(port, tassets)
    step._bind(state)
    names = step.keys(tbatch)
    body = functools.partial(step._body, update=True, generator=None,
                             names=names)
    seen = _uncapturable_ops(body, *[tbatch[k] for k in names])
    assert not seen, seen


@pytest.mark.parametrize('cfg_remat,model_remat', [(True, True),
                                                   (False, False),
                                                   (True, False),
                                                   (False, True)])
def test_trainer_takes_remat_from_the_model(cfg_remat, model_remat):
    from spec_tpu_torch.core.smpl import create_test_assets
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils.config import spec_default_config

    cfg = spec_default_config()
    cfg.LOGDIR = ''
    cfg.TRAINING.REMAT = cfg_remat
    assets = create_test_assets(num_vertices=64)
    model = HMR(backbone='resnet18', remat=model_remat)

    def build():
        return SpecTrainer(cfg, model, {'neutral': assets},
                           assets.j_regressor_h36m.numpy(), lambda e: None,
                           lambda: {})

    if cfg_remat == model_remat:
        assert build().model.backbone.remat is model_remat
    else:
        with pytest.raises(ValueError, match='TRAINING.REMAT'):
            build()


def test_spec_train_builds_the_remat_model():
    from spec_tpu_torch.cli.spec_train import build_model
    from spec_tpu_torch.utils.config import spec_default_config

    cfg = spec_default_config()
    cfg.HMR.BACKBONE = 'resnet18'
    cfg.TRAINING.REMAT = True
    model = build_model(cfg, '', torch.device('cpu'))
    assert model.backbone.remat and model.training
    plain = HMR(backbone='resnet18')
    assert model.state_dict().keys() == plain.state_dict().keys()
