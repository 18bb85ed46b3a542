"""spec_tpu_torch's train steps against spec_tpu's on the CPU.

The SPEC step at the ``train_steps`` golden's setup (ResNet-18 HMR with
camera features, B = 4 crops of 64², V = 128 synthetic SMPL,
``adam(1e-4)`` with the init buffers trained, the golden's batch from
``__graft_entry__``), with the JAX PRNGKey(0) weights carried over by
the bridge. Dropout is turned off on both sides for the step-by-step
comparison (no torch generator reproduces ``jax.random``'s masks): a
test-local monkeypatch makes ``flax.linen.Dropout`` the identity, and
the port's head drops at p = 0. The decoders keep their small random
init, so the trunk and the FC layers get gradients too.

Limits (fp32 on both sides, plain LBS in the JAX step and K1's plain
version or plain LBS in the port), after each of four steps of
``adam(1e-5)`` (three CamCalib steps):
* every loss term within 1e-4 relative, 1e-6 absolute (LOSS_RTOL,
  LOSS_ATOL; the camera term is about 1e-8);
* all parameters and BN statistics together within 1e-4 relative (the
  L2 error of the concatenation over its L2 norm, PARAM_RTOL);
* the update of the whole model (got - start against want - start,
  over the concatenation) within 3e-4 relative (UPDATE_MODEL_RTOL;
  read: 2.3e-5 to 5.8e-5 over the SPEC steps, 3.9e-5 and 3.1e-6 for
  CamCalib without and with the jitter);
* each tensor's update within 0.2 relative of JAX's (UPDATE_RTOL), and a
  tensor that JAX leaves as it was stays so. This holds the BN scales,
  the trained init buffers and the running statistics to their own
  update, which a limit on their values cannot see after a few steps
  at lr 1e-5: a missing, halved or reversed update is off by 1, 0.5 or
  2. Read: at most 0.014 over the SPEC steps (a BN scale of 64
  entries; init_cam 9e-8, init_pose 1e-5, the running variances
  3e-5), at most 0.071 for CamCalib (a 128-entry BN shift). Adam's
  step for an entry is ``m / (sqrt(v) + 1e-8)``: an entry whose
  gradient is rounding noise on both sides moves by up to +-lr in
  different directions, which is what those readings are (the
  optimizer itself is held to optax on identical gradients in
  ``test_torch_train_state.py``). The same sign noise makes the
  trajectories drift apart a few times faster per step at the golden's
  lr 1e-4 than at 1e-5, which is why the step-by-step comparison runs
  at 1e-5 (the whole-model error reads 1.1e-6 after one step and
  1.9e-5 after five);
* the golden's first value (zeroed decoders, dropout on, ``adam(1e-4)``)
  within the golden test's rtol 2e-3.
"""

import functools
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from spec_tpu.core import smpl as JS
from spec_tpu.models import HMR as JaxHMR
from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib
from spec_tpu.train import adam as jax_adam
from spec_tpu.train import create_train_state as jax_create_train_state
from spec_tpu.train import make_camcalib_train_step as jax_camcalib_step
from spec_tpu.train import make_spec_train_step as jax_spec_step
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.train import (
    adam,
    create_train_state,
    make_camcalib_train_step,
    make_spec_train_step,
)
from spec_tpu_torch.utils.checkpoints import (
    assets_from_jax,
    state_dict_from_flax,
)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
PARAM_RTOL = 1e-4
UPDATE_MODEL_RTOL = 3e-4
UPDATE_RTOL = 0.2
LR = 1e-5
GOLDEN_RTOL = 2e-3
B, RES, V = 4, 64, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, '__call__',
                        lambda self, x, deterministic=None, rng=None: x)


def _setup(zero_decoders=False):
    """(JAX model, variables, assets, batch) at the golden's setup, and
    the port's model with the same weights, its assets and batch."""
    rng = np.random.RandomState(0)
    jassets = JS.create_test_assets(num_vertices=V)
    jmodel = JaxHMR(backbone='resnet18', use_cam=True, use_cam_feats=True)
    args = ge._example_inputs(B, RES, rng)
    variables = jmodel.init(jax.random.PRNGKey(0), jassets, *args)
    if zero_decoders:
        ge._zero_head_decoders(variables)
    jbatch = ge._example_batch(B, rng, args)
    port = HMR(backbone='resnet18', use_cam_feats=True)
    port.load_state_dict(state_dict_from_flax(variables, 'hmr', 'resnet18'))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jmodel, variables, jassets, jbatch, port, \
        assets_from_jax(jassets), tbatch


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_state_dict(state):
    return state_dict_from_flax(
        {'params': jax.device_get(state.params),
         'batch_stats': jax.device_get(state.batch_stats)},
        'hmr', 'resnet18')


def _hold_losses(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


def _hold_params(got, want, start, where):
    """PARAM_RTOL on the whole model; UPDATE_MODEL_RTOL on its update and
    UPDATE_RTOL on each tensor's (got - start against want - start); a
    tensor the JAX step left as it was stays so."""
    num = den = uden = 0.0
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        g64, w64 = (np.asarray(t, np.float64) for t in (got[k], w))
        s64 = np.asarray(start[k], np.float64)
        num += np.sum((g64 - w64) ** 2)
        den += np.sum(w64 ** 2)
        uden += np.sum((w64 - s64) ** 2)
        if np.any(w64 - s64):
            err = _rel(g64 - s64, w64 - s64)
            assert err <= UPDATE_RTOL, (where, k, err)
        else:
            assert not np.any(g64 - s64), (where, k)
    assert np.sqrt(num / den) <= PARAM_RTOL, (where, np.sqrt(num / den))
    assert np.sqrt(num / uden) <= UPDATE_MODEL_RTOL, (where,
                                                      np.sqrt(num / uden))


def test_spec_step_matches_jax_over_steps(monkeypatch):
    """Four steps, dropout off, random decoders, the init buffers
    trained: losses, every parameter and every BN statistic, after each
    step."""
    _no_dropout(monkeypatch)
    jmodel, variables, jassets, jbatch, port, tassets, tbatch = _setup()
    port.head.dropout_rate = 0.0
    tx = jax_adam(LR)
    jstate = jax_create_train_state(variables, tx)
    jstep = jax.jit(jax_spec_step(jmodel, jassets, tx))
    state = create_train_state(port, adam(LR))
    step = make_spec_train_step(port, tassets)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    key = jax.random.PRNGKey(1)
    for i in range(4):
        jstate, jl = jstep(jstate, jbatch, key)
        state, tl = step(state, tbatch)
        _hold_losses(tl, jl)
        assert state.step == i + 1 and int(jstate.step) == i + 1
        got = port.state_dict()
        _hold_params(got, _jax_state_dict(jstate), start, i)
    # the statistics, the trunk and the init buffers all moved (and
    # moved as JAX's did, above)
    for k in ('backbone.bn1.running_var', 'backbone.conv1.weight',
              'head.init_cam'):
        assert not torch.equal(got[k], start[k]), k


def test_golden_first_loss():
    """``train_steps[0]`` of tests/goldens.json: zeroed decoders, dropout
    on (the first value is independent of the masks: the decoders that
    read the dropped features are zero)."""
    with open(os.path.join(ROOT, 'tests', 'goldens.json')) as f:
        golden = json.load(f)['train_steps']['total_loss']
    *_, port, tassets, tbatch = _setup(zero_decoders=True)
    state = create_train_state(port, adam(1e-4))
    step = make_spec_train_step(port, tassets)
    state, losses = step(state, tbatch, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(losses['loss/total_loss']), golden[0],
                               rtol=GOLDEN_RTOL)


def test_spec_step_dropout_rate():
    """In train mode the head drops at 0.5 from the step's generator:
    the same generator seed gives the same step, another seed another,
    and a dropped fc1 feature count near half."""
    *_, port, tassets, tbatch = _setup()
    head = port.head
    head.train()
    x = torch.ones(64, 1024)
    assert head.dropout_rate == 0.5
    kept = head._drop(x, torch.Generator().manual_seed(0))
    frac = float((kept == 0).float().mean())
    assert 0.45 < frac < 0.55
    assert set(torch.unique(kept).tolist()) == {0.0, 2.0}
    outs = []
    for seed in (3, 3, 4):
        m = HMR(backbone='resnet18', use_cam_feats=True)
        m.load_state_dict(port.state_dict())
        state = create_train_state(m, adam(1e-4))
        state, losses = make_spec_train_step(m, tassets)(
            state, tbatch, torch.Generator().manual_seed(seed))
        outs.append(float(losses['loss/total_loss']))
    assert outs[0] == outs[1] != outs[2]


@pytest.mark.parametrize('jitter', [False, True])
def test_camcalib_step_matches_jax(jitter):
    """Three CamCalib steps (ResNet-18, one FC layer per head,
    softargmax-biased-L2 with the released recipe's weights 10), with and
    without the on-device jitter: losses and parameters."""
    rng = np.random.RandomState(7)
    Bc, H, W = 4, 48, 64
    jmodel = JaxCamCalib(backbone='resnet18', num_fc_layers=1)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, H, W, 3)))
    port = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
    port.load_state_dict(state_dict_from_flax(variables, 'camcalib',
                                              'resnet18'))
    batch = {'vfov': rng.uniform(-1, 1, Bc).astype('f4'),
             'pitch': rng.uniform(-1, 1, Bc).astype('f4'),
             'roll': rng.uniform(-1, 1, Bc).astype('f4')}
    if jitter:
        batch['img'] = rng.randint(0, 256, (Bc, H, W, 3)).astype(np.uint8)
        A = np.eye(3, dtype='f4')[None] * rng.uniform(0.7, 1.3, (Bc, 1, 1))
        batch['jitter_A'] = (A + rng.randn(Bc, 3, 3) * 0.05).astype('f4')
        batch['jitter_b'] = (rng.randn(Bc, 3) * 10).astype('f4')
        batch['true_shape'] = np.array([[H, W], [H - 8, W], [H, W - 16],
                                        [40, 50]], np.int32)
    else:
        batch['img'] = rng.randn(Bc, H, W, 3).astype('f4')
    kw = dict(loss_type='softargmax_biased_l2', vfov_loss_weight=10.0,
              pitch_loss_weight=10.0, roll_loss_weight=10.0)
    tx = jax_adam(LR)
    jstate = jax_create_train_state(variables, tx)
    jstep = jax.jit(jax_camcalib_step(jmodel, tx, **kw))
    state = create_train_state(port, adam(LR))
    step = make_camcalib_train_step(port, **kw)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jl = jstep(jstate, jb)
        state, tl = step(state, tb)
        _hold_losses(tl, jl)
    want = state_dict_from_flax(
        {'params': jax.device_get(jstate.params),
         'batch_stats': jax.device_get(jstate.batch_stats)},
        'camcalib', 'resnet18')
    _hold_params(port.state_dict(), want, start, 'camcalib')


@pytest.mark.parametrize('masked', [False, True])
def test_device_jitter_normalize_matches_jax(masked):
    """DATASET.DEVICE_JITTER's on-device ColorJitter + normalize and its
    pad mask rebuilt from ``true_shape``: within 1e-5 (fp32)."""
    from spec_tpu.ops.preprocess import device_jitter_normalize as jfn
    from spec_tpu_torch.ops.preprocess import device_jitter_normalize

    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (3, 20, 24, 3)).astype(np.uint8)
    A = (np.eye(3, dtype='f4') * rng.uniform(0.6, 1.4, (3, 1, 1))
         + rng.randn(3, 3, 3).astype('f4') * 0.1).astype('f4')
    b = (rng.randn(3, 3) * 20).astype('f4')
    ts = np.array([[20, 24], [11, 24], [20, 5]], np.int32) if masked \
        else None
    want = np.asarray(jfn(jnp.asarray(img), jnp.asarray(A), jnp.asarray(b),
                          None if ts is None else jnp.asarray(ts)))
    got = device_jitter_normalize(
        torch.from_numpy(img), torch.from_numpy(A), torch.from_numpy(b),
        None if ts is None else torch.from_numpy(ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if masked:
        assert not got[1, 11:].any() and not got[2, :, 5:].any()


@pytest.mark.parametrize('update', [True, False])
def test_train_step_is_capturable(update):
    """The SPEC step body (forward, loss, backward, optimizer update; and
    the accumulating micro-step of GRAD_ACCUM_STEPS = 2) builds no tensor
    from host data, reads nothing back on the host and takes no
    data-dependent shape after a warm-up call, each of which would fail
    its CUDA graph capture (the aten operations
    ``tests/test_torch_graphs.py`` watches for)."""
    from spec_tpu_torch.train.state import Transform
    from tests.test_torch_graphs import _uncapturable_ops

    *_, port, tassets, tbatch = _setup()
    state = create_train_state(port, Transform(
        'adam', 1e-4, clip_norm=1.0, every_k=1 if update else 2))
    step = make_spec_train_step(port, tassets)
    step._bind(state)
    names = step.keys(tbatch)
    body = functools.partial(step._body, update=update, generator=None,
                             names=names)
    seen = _uncapturable_ops(body, *[tbatch[k] for k in names])
    assert not seen, seen
