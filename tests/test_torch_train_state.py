"""spec_tpu_torch.train.state against spec_tpu.train.state (optax) on the
CPU: every optimizer type, schedule, clip, accumulation and freeze
setting, over 5 optimizer updates of the same seeded gradients.

Limits: parameters within 1e-6 relative per tensor (PARAM_RTOL) and
1e-8 absolute (fp32 on both sides; the same operations in the same
order up to the rounding of a division against a multiplication by its
reciprocal, ~1e-7 per update).
"""

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spec_tpu.train import state as JS
from spec_tpu_torch.train import state as TS

PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-8
SHAPES = {'w': (6, 5), 'b': (5,), 'init_pose': (1, 12), 'init_cam': (1, 3)}
UPDATES = 5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Tiny(torch.nn.Module):
    """Two parameters and two HMR-style init buffers."""

    def __init__(self, values):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(values['w'].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(values['b'].copy()))
        self.register_buffer('init_pose',
                             torch.from_numpy(values['init_pose'].copy()))
        self.register_buffer('init_cam',
                             torch.from_numpy(values['init_cam'].copy()))


def _values(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _cfg(**kw):
    base = dict(TYPE='adam', LR=1e-2, WD=0.0, SCHEDULE='', WARMUP_STEPS=0,
                DECAY_STEPS=0, DECAY_RATE=0.1, MIN_LR_RATIO=0.0,
                CLIP_GRAD_NORM=0.0, MOMENTUM=0.9)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _run_jax(cfg, freeze, accum, init, grads_seq):
    tx = JS.make_optimizer(cfg, freeze_buffers=freeze,
                           grad_accum_steps=accum)
    params = {'head': {k: jnp.asarray(init[k])
                       for k in ('init_pose', 'init_cam')},
              'w': jnp.asarray(init['w']), 'b': jnp.asarray(init['b'])}
    opt_state = tx.init(params)
    for g in grads_seq:
        grads = {'head': {k: jnp.asarray(g[k])
                          for k in ('init_pose', 'init_cam')},
                 'w': jnp.asarray(g['w']), 'b': jnp.asarray(g['b'])}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return {'w': params['w'], 'b': params['b'],
            **{k: params['head'][k] for k in ('init_pose', 'init_cam')}}


def _run_port(cfg, freeze, accum, init, grads_seq):
    tx = TS.make_optimizer(cfg, freeze_buffers=freeze,
                           grad_accum_steps=accum)
    model = _Tiny(init)
    state = TS.create_train_state(model, tx)
    opt = state.optimizer
    names = {id(t): n for n, t in list(model.named_parameters())
             + list(model.named_buffers())}
    order = [names[id(p)] for p in opt.params]
    assert set(order) == ({'w', 'b'} if freeze else set(SHAPES))
    for g in grads_seq:
        update = opt.will_update()
        opt.step([torch.from_numpy(g[n].copy()) for n in order], update)
        opt.host_mini = 0 if update else opt.host_mini + 1
    return {n: getattr(model, n).detach().numpy() for n in SHAPES}


CASES = {
    'adam': dict(),
    'adam_l2': dict(WD=0.05),
    'adamw': dict(TYPE='adamw', WD=0.05),
    'sgd_momentum_l2': dict(TYPE='sgd', WD=0.05, LR=0.1),
    'sgd_plain': dict(TYPE='sgd', MOMENTUM=0.0, LR=0.1),
    'constant_warmup': dict(WARMUP_STEPS=3),
    'cosine_warmup': dict(SCHEDULE='cosine', WARMUP_STEPS=1, DECAY_STEPS=3,
                          MIN_LR_RATIO=0.1),
    'cosine': dict(SCHEDULE='cosine', DECAY_STEPS=4),
    'step': dict(SCHEDULE='step', DECAY_STEPS=2, DECAY_RATE=0.5),
    'clip': dict(CLIP_GRAD_NORM=0.5),
    'clip_inactive': dict(CLIP_GRAD_NORM=1e3),
    'sgd_clip_cosine': dict(TYPE='sgd', LR=0.1, CLIP_GRAD_NORM=0.5,
                            SCHEDULE='cosine', WARMUP_STEPS=2,
                            DECAY_STEPS=2),
}


@pytest.mark.parametrize('freeze', [False, True])
@pytest.mark.parametrize('accum', [1, 2])
@pytest.mark.parametrize('case', sorted(CASES))
def test_optimizer_matches_optax(case, accum, freeze):
    cfg = _cfg(**CASES[case])
    init = _values(0)
    grads_seq = [_values(10 + i) for i in range(UPDATES * accum)]
    want = _run_jax(cfg, freeze, accum, init, grads_seq)
    got = _run_port(cfg, freeze, accum, init, grads_seq)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
        if freeze and k.startswith('init_'):
            np.testing.assert_array_equal(got[k], init[k])


@pytest.mark.parametrize('schedule', [
    dict(), dict(WARMUP_STEPS=4), dict(SCHEDULE='cosine', DECAY_STEPS=5),
    dict(SCHEDULE='cosine', WARMUP_STEPS=2, DECAY_STEPS=5,
         MIN_LR_RATIO=0.2),
    dict(SCHEDULE='step', DECAY_STEPS=3, DECAY_RATE=0.3)])
def test_lr_schedule_matches_optax(schedule):
    """The schedule at counts 0..11 (past its end) equals optax's."""
    cfg = _cfg(**schedule)
    kw = dict(schedule=cfg.SCHEDULE, warmup_steps=cfg.WARMUP_STEPS,
              decay_steps=cfg.DECAY_STEPS, decay_rate=cfg.DECAY_RATE,
              min_lr_ratio=cfg.MIN_LR_RATIO)
    want = JS.lr_schedule(cfg.LR, **kw)
    got = TS.lr_schedule(cfg.LR, **kw)
    for c in range(12):
        w = want(c) if callable(want) else want
        g = got(torch.tensor(float(c))) if callable(got) else got
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))


def test_adam_l2_is_torch_adam_weight_decay():
    """``adam(lr, wd)`` is ``torch.optim.Adam(weight_decay=wd)``, within
    1e-5 relative: torch divides by ``sqrt(v) / sqrt(1 - b2^t) + eps``
    and scales by ``lr / (1 - b1^t)``, optax bias-corrects the moments
    first (1.8e-6 apart after 5 updates)."""
    init = _values(0)
    grads_seq = [_values(10 + i) for i in range(UPDATES)]
    model = _Tiny(init)
    ref = torch.nn.Parameter(torch.from_numpy(init['w'].copy()))
    opt = torch.optim.Adam([ref], lr=1e-2, weight_decay=0.05)
    state = TS.create_train_state(model, TS.adam(1e-2, 0.05))
    for g in grads_seq:
        ref.grad = torch.from_numpy(g['w'].copy())
        opt.step()
        state.optimizer.step([torch.from_numpy(g[n].copy())
                              for n in ('w', 'b', 'init_pose', 'init_cam')],
                             True)
    np.testing.assert_allclose(model.w.detach().numpy(),
                               ref.detach().numpy(), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize('bad', [dict(TYPE='lamb'), dict(SCHEDULE='poly'),
                                 dict(SCHEDULE='cosine'),
                                 dict(SCHEDULE='step')])
def test_bad_config_raises_like_jax(bad):
    cfg = _cfg(**bad)
    with pytest.raises(ValueError):
        JS.make_optimizer(cfg)
    with pytest.raises(ValueError):
        TS.make_optimizer(cfg)


def test_state_dict_round_trip():
    """An optimizer state saved mid-accumulation and loaded into a fresh
    one continues the same trajectory; a state of another rule is
    refused."""
    cfg = _cfg(CLIP_GRAD_NORM=0.5)
    init = _values(0)
    grads_seq = [_values(10 + i) for i in range(7)]
    tx = TS.make_optimizer(cfg, grad_accum_steps=2)

    def run(model, opt, gs):
        for g in gs:
            update = opt.will_update()
            opt.step([torch.from_numpy(g[n].copy())
                      for n in ('w', 'b', 'init_pose', 'init_cam')], update)
            opt.host_mini = 0 if update else opt.host_mini + 1

    m1 = _Tiny(init)
    s1 = TS.create_train_state(m1, tx)
    run(m1, s1.optimizer, grads_seq)
    m2 = _Tiny(init)
    s2 = TS.create_train_state(m2, tx)
    run(m2, s2.optimizer, grads_seq[:3])
    saved = s2.optimizer.state_dict()
    m3 = _Tiny({n: getattr(m2, n).detach().numpy() for n in SHAPES})
    s3 = TS.create_train_state(m3, tx)
    s3.optimizer.load_state_dict(saved)
    run(m3, s3.optimizer, grads_seq[3:])
    for n in SHAPES:
        torch.testing.assert_close(getattr(m3, n), getattr(m1, n),
                                   rtol=0, atol=0)
    other = TS.create_train_state(_Tiny(init), TS.make_optimizer(
        _cfg(TYPE='sgd')))
    with pytest.raises(ValueError):
        other.optimizer.load_state_dict(saved)


def test_jax_freeze_labels_match_port_buffers():
    """The JAX freeze labels exactly the leaves the port keeps as
    buffers (``init_pose/init_shape/init_cam``)."""
    assert set(TS.INIT_BUFFERS) == {'init_pose', 'init_shape', 'init_cam'}
    tx = JS.freeze_init_buffers(optax.sgd(1.0))
    params = {'head': {'init_pose': jnp.ones(2), 'init_shape': jnp.ones(2),
                       'init_cam': jnp.ones(2), 'fc1': jnp.ones(2)}}
    upd, _ = tx.update(params, tx.init(params), params)
    frozen = {k for k, v in upd['head'].items() if not np.any(v)}
    assert frozen == set(TS.INIT_BUFFERS)
