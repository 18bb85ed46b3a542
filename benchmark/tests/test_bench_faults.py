"""The check can fail: a run at the CPU's size with the timed path broken
underneath comes out not correct, once for each fault a cell can have
(predict: an answer altered where it is produced, persons left out, half
of a batch answered with the other half's results; the train step: half
of the batch left out with the mean over the rest, the loss altered where
it is produced, the state left unchanged); and on a card the control
(the reference in TF32, the precision next below the cells' float32 with
TF32 off) fails the cells' limits at their own size."""

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests import tiny

SEED = 2 ** 31 + 77
# Limits of the CPU cell: its sound runs read 1e-5 at most (one BLAS on
# both sides); a broken one reads 1e-2 or more.
LIMITS = {'camera_rad': 1e-3, 'focal_rel': 1e-3, 'pose6d': 1e-3,
          'shape': 1e-3, 'cam': 1e-3, 'verts_m': 1e-3, 'joints3d_m': 1e-3,
          'joints2d_px': 1e-2, 'missing': 0.0}


@pytest.fixture(autouse=True, scope='module')
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(monkeypatch, broken=None):
    from spec_tpu_torch import serving

    if broken is not None:
        predict = serving.SpecPredictor.predict

        def wrapped(self, frames, boxes=None, *a, **kw):
            out = predict(self, frames, boxes, *a, **kw)
            if kw.get('stream') == 'bench':
                broken(out)
            return out

        monkeypatch.setattr(serving.SpecPredictor, 'predict', wrapped)
    return run.run(tiny.cell(limits=LIMITS), SEED, 1.5, False, 'cpu')


def test_a_sound_run_is_correct(monkeypatch):
    res = _run(monkeypatch)
    assert res['correct'], json.dumps(res['checks'])
    assert res['failed'] == 0 and res['attempted'] > 3
    assert list(res)[-1] == 'checks'


def _alter(out):
    out[0][0]['smpl_vertices'] = out[0][0]['smpl_vertices'] + np.float32(
        0.01)


def _drop(out):
    out[-1].pop()


def _half(out):
    people = [p for frame in out for p in frame]
    half = len(people) // 2
    for k in range(half, 2 * half):
        people[k].update(copy.deepcopy(
            {n: v for n, v in people[k - half].items() if n != 'camera'}))


@pytest.mark.parametrize('fault', [_alter, _drop, _half])
def test_a_broken_answer_is_not_correct(monkeypatch, fault):
    res = _run(monkeypatch, fault)
    assert not res['correct']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['r50-crowd-video', 'r50-photo-batch',
                                      'hrnet-crowd-video', 'r50-train-b64'])
def test_control_fails_and_program_passes_on_the_card(card, workload):
    cell = run.Cell.load(workload)
    program, control, _, _ = calibrate.readings(cell, SEED, 1.0)
    assert run.passed(run.checks(program, cell.limits))
    assert not run.passed(run.checks(control, cell.limits))


TRAIN_LIMITS = {'loss': 1e-4, 'grad_norm': 1e-3, 'change_norm': 1e-2}


def _train(monkeypatch, where=None, broken=None):
    if where is not None:
        monkeypatch.setattr(*where, broken)
    return run.run(tiny.cell('train_b64', limits=TRAIN_LIMITS), SEED, 1.0,
                   False, 'cpu')


def test_a_sound_train_run_is_correct(monkeypatch):
    res = _train(monkeypatch)
    assert res['correct'], json.dumps(res['checks'])


def _half_batch_loss():
    from spec_tpu_torch.train import steps

    loss = steps.hmr_cam_loss

    def half(pred, gt, cfg):
        n = gt['img'].shape[0] // 2

        def cut(d):
            return {k: v[:n] if torch.is_tensor(v) and v.ndim and
                    v.shape[0] == 2 * n else v for k, v in d.items()}
        return loss(cut(pred), cut(gt), cfg)

    return (steps, 'hmr_cam_loss'), half


def _scaled_loss():
    from spec_tpu_torch.train import steps

    loss = steps.hmr_cam_loss

    def scaled(pred, gt, cfg):
        total, terms = loss(pred, gt, cfg)
        return total * 1.01, dict(terms, **{'loss/total_loss': total * 1.01})

    return (steps, 'hmr_cam_loss'), scaled


def _frozen_state():
    from spec_tpu_torch.train import state

    return (state.Optimizer, 'step'), lambda self, grads, update: None


@pytest.mark.parametrize('fault', [_half_batch_loss, _scaled_loss,
                                   _frozen_state])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    where, broken = fault()
    res = _train(monkeypatch, where, broken)
    assert not res['correct'], json.dumps(res['checks'])
