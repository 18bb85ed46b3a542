"""spec_tpu_torch's data-parallel training in two processes on the CPU
(gloo), against the JAX package's mesh step and against one process.

One module-scoped run spawns two ranks of ``tests/mp_torch_worker.py``
(a free port, ``OMP_NUM_THREADS=1``, a timeout), each at ResNet-18 width:

* three SPEC train steps over a global batch of 8 crops of 64² whose
  halves hold different numbers of ``has_smpl`` and ``has_pose_3d`` rows,
  held to the JAX step on a 2-device mesh (``jax.jit`` with the batch
  sharded, as ``tests/test_multiprocess.py`` runs it) at
  ``tests/test_torch_train_step.py``'s step-parity limits (dropout off on
  both sides, ``adam(1e-5)``). On the same batch, the mean of the two
  halves' losses with per-half BatchNorm statistics (torch DDP's
  default) misses those limits;
* ``all_processes_any`` with a flag raised on rank 1 only, and
  ``broadcast_string``;
* one CamCalib train step, two processes against one;
* a ``SpecTrainer`` epoch preempted after one step (a SIGTERM seen by
  rank 0 only; rank 0 alone writes the checkpoint) and resumed on both
  ranks, which end with the same weights as one process that trained
  the epoch straight through.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from spec_tpu import parallel as jpar
from spec_tpu.core import smpl as JS
from spec_tpu.models import HMR as JaxHMR
from spec_tpu.train import adam as jax_adam
from spec_tpu.train import create_train_state as jax_create_train_state
from spec_tpu.train import make_spec_train_step as jax_spec_step
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.data.cam_dataset import AugmentationConfig
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.train import (
    adam,
    create_train_state,
    make_camcalib_train_step,
    make_spec_train_step,
)
from spec_tpu_torch.utils.checkpoints import state_dict_from_flax
from tests.test_torch_train_data import write_train_set
from tests.test_torch_train_step import (
    LOSS_ATOL,
    LOSS_RTOL,
    _hold_losses,
    _hold_params,
    _jax_state_dict,
    _no_dropout,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, RES, V = 8, 64, 128
# rank 0's half holds 3 SMPL rows and 3 3D rows, rank 1's 1 and 1
HAS_SMPL = np.array([1, 1, 1, 0, 1, 0, 0, 0], 'f4')
HAS_POSE_3D = np.array([1, 1, 0, 1, 0, 0, 1, 0], 'f4')
LR = 1e-5
TIMEOUT = 240
# the trainer's augmentations, their effects off (a rank's slice changes
# the order of their one random stream)
NO_AUG = AugmentationConfig(noise_factor=0.0, scale_factor=0.0,
                            use_motion_blur=False)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spec_setup():
    rng = np.random.RandomState(0)
    jassets = JS.create_test_assets(num_vertices=V)
    jmodel = JaxHMR(backbone='resnet18', use_cam=True, use_cam_feats=True)
    args = ge._example_inputs(B, RES, rng)
    variables = jmodel.init(jax.random.PRNGKey(0), jassets, *args)
    batch = {k: np.array(v) for k, v in
             ge._example_batch(B, rng, args).items()}
    batch['has_smpl'], batch['has_pose_3d'] = HAS_SMPL, HAS_POSE_3D
    batch['pose_conf'] = rng.rand(B, 24).astype('f4')
    return jmodel, jax.device_get(variables), jassets, batch


def _camcalib_setup():
    rng = np.random.RandomState(7)
    model = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
    model.reset_parameters(torch.Generator().manual_seed(3))
    batch = {'img': rng.randn(4, 48, 64, 3).astype('f4'),
             'vfov': rng.uniform(-1, 1, 4).astype('f4'),
             'pitch': rng.uniform(-1, 1, 4).astype('f4'),
             'roll': rng.uniform(-1, 1, 4).astype('f4')}
    return model, batch


def _jax_mesh_steps(jmodel, variables, jassets, batch, n=3):
    """The JAX SPEC step on a 2-device mesh, the batch sharded over it,
    dropout off: (the losses of each step, the final state)."""
    tx = jax_adam(LR)
    mesh = jpar.create_mesh(jax.devices()[:2])
    rep = jpar.replicated(mesh)
    jstep = jax.jit(jax_spec_step(jmodel, jassets, tx),
                    in_shardings=(rep, jpar.batch_sharding(mesh), rep),
                    out_shardings=(rep, rep))
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, variables),
                                    tx)
    jbatch = jpar.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              mesh)
    key = jpar.replicate(jax.random.PRNGKey(1), mesh)
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        for _ in range(n):
            jstate, jl = jstep(jstate, jbatch, key)
            losses.append({k: float(v) for k, v in jl.items()})
    return losses, jstate


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The inputs, both ranks' outputs and logs, and the JAX mesh step's
    results (computed while the ranks run)."""
    d = tmp_path_factory.mktemp('mp_torch')
    jmodel, variables, jassets, batch = _spec_setup()
    torch.save(state_dict_from_flax(variables, 'hmr', 'resnet18'),
               d / 'spec_init.pt')
    np.savez(d / 'spec_batch.npz', **batch)
    cam_model, cam_batch = _camcalib_setup()
    torch.save(cam_model.state_dict(), d / 'camcalib_init.pt')
    np.savez(d / 'camcalib_batch.npz', **cam_batch)
    trainer_model = HMR(backbone='resnet18')
    trainer_model.reset_parameters(torch.Generator().manual_seed(5))
    torch.save(trainer_model.state_dict(), d / 'trainer_init.pt')
    write_train_set(str(d / 'train'))

    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    port = _free_port()
    worker = os.path.join(ROOT, 'tests', 'mp_torch_worker.py')
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), '2', str(port), str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        jlosses, jstate = _jax_mesh_steps(jmodel, variables, jassets, batch)
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), '\n'.join(logs)
    outs = [torch.load(d / f'rank{r}.pt', weights_only=False)
            for r in range(2)]
    return dict(dir=d, logs=logs, outs=outs, batch=batch,
                jlosses=jlosses, jstate=jstate, cam_model=cam_model,
                cam_batch=cam_batch, trainer_model=trainer_model)


def test_two_process_spec_steps_match_jax_mesh(run):
    jlosses, jstate = run['jlosses'], run['jstate']
    start = torch.load(run['dir'] / 'spec_init.pt')
    r0, r1 = run['outs']
    assert r0['backend'] == 'gloo' and r0['spec_mode'] == 'eager'
    assert r0['spec_rows'] == r1['spec_rows'] == B // 2
    for got, got1, want in zip(r0['spec_losses'], r1['spec_losses'],
                               jlosses):
        assert got == got1                 # global metrics on every rank
        _hold_losses(got, want)
    _hold_params(r0['spec_state'], _jax_state_dict(jstate), start, 'mp')
    for k, v in r0['spec_state'].items():
        torch.testing.assert_close(r1['spec_state'][k], v, rtol=0, atol=0)

    # The same batch as two per-rank means with per-rank BatchNorm
    # statistics misses the limits the two processes meet.
    halves = []
    for h in range(2):
        model = HMR(backbone='resnet18', use_cam_feats=True)
        model.load_state_dict(start)
        model.head.dropout_rate = 0.0
        step = make_spec_train_step(model, S.create_test_assets(
            num_vertices=V))
        half = {k: torch.from_numpy(v[h * 4:(h + 1) * 4])
                for k, v in run['batch'].items()}
        _, m = step(create_train_state(model, adam(LR)), half)
        halves.append({k: float(v) for k, v in m.items()})
    k = 'loss/total_loss'
    per_rank = (halves[0][k] + halves[1][k]) / 2
    want = jlosses[0][k]
    assert abs(per_rank - want) > LOSS_RTOL * abs(want) + LOSS_ATOL, \
        (per_rank, want)


def test_two_process_agreements(run):
    for out in run['outs']:
        assert out['any_rank1'] is True and out['any_none'] is False
        assert out['string'] == 'logs/rank0'


def test_two_process_camcalib_step_matches_one_process(run):
    model = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
    start = run['cam_model'].state_dict()
    model.load_state_dict(start)
    step = make_camcalib_train_step(
        model, loss_type='softargmax_biased_l2', vfov_loss_weight=10.0,
        pitch_loss_weight=10.0, roll_loss_weight=10.0)
    _, metrics = step(create_train_state(model, adam(LR)),
                      {k: torch.from_numpy(v)
                       for k, v in run['cam_batch'].items()})
    r0, r1 = run['outs']
    assert r0['camcalib_losses'] == r1['camcalib_losses']
    _hold_losses(r0['camcalib_losses'], {k: float(v)
                                         for k, v in metrics.items()})
    _hold_params(r0['camcalib_state'], model.state_dict(), start,
                 'camcalib')


def test_two_process_trainer_preempt_resume(run, monkeypatch):
    from spec_tpu_torch.data.cam_dataset import CamDataset
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils.config import spec_default_config

    # no TensorBoard writer (its import takes seconds; not checked here)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    r0, r1 = run['outs']
    assert r0['preempted_at'] == r1['preempted_at'] == 1
    assert r0['resumed_at'] == r1['resumed_at'] == 1
    assert r0['trainer_steps'] == r1['trainer_steps'] == 3
    assert r0['trainer_logdir'] == r1['trainer_logdir']
    assert 'checkpoint saved' in run['logs'][0]
    assert 'checkpoint saved' not in run['logs'][1]
    assert 'its eager body' in run['logs'][0]
    ckpts = sorted(os.listdir(os.path.join(r0['trainer_logdir'],
                                           'checkpoints')))
    assert ckpts == ['meta.json', 'step_00000001', 'step_00000003']
    assert not os.path.exists(run['dir'] / 'run1')
    for k, v in r0['trainer_state'].items():
        torch.testing.assert_close(r1['trainer_state'][k], v, rtol=0, atol=0)

    # one process, the same epoch straight through
    cfg = spec_default_config()
    cfg.LOGDIR = str(run['dir'] / 'single')
    cfg.LOG_FREQ_TB_IMAGES = 0
    cfg.SEED_VALUE = 0
    cfg.HMR.BACKBONE = 'resnet18'
    cfg.OPTIMIZER.LR = LR
    cfg.DATASET.BATCH_SIZE = 2
    cfg.DATASET.NUM_WORKERS = 0
    cfg.DATASET.IMG_RES = 64
    cfg.TRAINING.MAX_EPOCHS = 1
    model = HMR(backbone='resnet18')
    model.load_state_dict(run['trainer_model'].state_dict())
    model.head.dropout_rate = 0.0
    train = run['dir'] / 'train'
    assets = S.create_test_assets(num_vertices=V)
    trainer = SpecTrainer(
        cfg, model, {'neutral': assets}, assets.j_regressor_h36m.numpy(),
        lambda epoch: CamDataset(str(train / 'annots.npz'),
                                 str(train / 'imgs'), 'spec-syn',
                                 is_train=True, img_res=64, seed=epoch,
                                 aug=NO_AUG),
        dict)
    trainer.fit(1)
    assert trainer.state.step == 3
    _hold_params(r0['trainer_state'], model.state_dict(),
                 run['trainer_model'].state_dict(), 'trainer')
