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
  the epoch straight through;
* FSDP and HSDP (``parallel/fsdp.py``) on the inputs of the reference's
  ``tests/test_parallel_train.py::test_camcalib_train_step_fsdp_matches_
  replicated`` (ResNet-18 CamCalib, 64², B = 16, two SGD steps at 1e-2,
  here with momentum 0.9 so that the trace slot is sharded too): full-
  axis FSDP over the two ranks and, in a second spawn of four ranks, HSDP
  over a (2, 2) mesh, each against the port's replicated run on the same
  ranks (loss within rtol 1e-5, parameters within atol 1e-6: the sums
  only change order) and against the JAX package's FSDP step on a
  2-device mesh and HSDP step on ``create_hybrid_mesh(jax.devices()[:4],
  fsdp=2)`` at the step-parity limits; each rank's slots hold only its
  slices (under HSDP equal across a data group, different within an
  fsdp group); both layouts again with the global-norm clip at 1e-3 (which
  moves the update), against the replicated run with it;
* ``SpecTrainer`` with TRAINING.FSDP on two ranks preempted mid-epoch and
  resumed bit for bit with its layout, after the reference's
  ``test_fsdp_preemption_resume_bit_exact``; an FSDP checkpoint resumes
  a plain run and a plain checkpoint an FSDP run, bit for bit;
* every update rule (SGD with momentum, Adam, AdamW) with weight decay,
  the clip and gradient accumulation on a small net, sharded over two
  and four ranks against replicated;
* the ``spec_eval`` CLI as two ranks (the worker's ``val`` mode; the
  reference's ``tests/test_multiprocess.py::test_two_process_validation_
  matches_single_process`` with its data maker at 24 samples, IMG_RES 32,
  ResNet-18): each rank evaluates the whole val set, the metrics equal
  across ranks and equal to one process, and one LOGDIR holds the
  artifacts, written by rank 0.
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
from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib
from spec_tpu.train import make_camcalib_train_step as jax_camcalib_step
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
from tests.mp_torch_worker import VAL_OPTS
from tests.test_cli import _make_train_data_root
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
# the reference FSDP test's batch (B, side) and the worker's SGD
FSDP_B, FSDP_RES = 16, 64
FSDP_STEPS, FSDP_LR, FSDP_MOMENTUM = 2, 1e-2, 0.9
# sharded against replicated on the same ranks (the reference's limits)
LAYOUT_LOSS_RTOL, LAYOUT_PARAM_ATOL = 1e-5, 1e-6
# the sharded update against the replicated one under the clip (L2 over
# every parameter, relative; the clipped update is ~1e-8 of parameters
# near 1, so their fp32 rounding alone reads ~7e-4)
LAYOUT_UPDATE_RTOL = 1e-2
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


def _fsdp_setup():
    """The reference FSDP test's CamCalib (ResNet-18, one FC layer per
    head, PRNGKey(0) init) and batch of 16 crops of 64²."""
    rng = np.random.RandomState(0)
    B = FSDP_B
    batch = {'img': rng.randn(B, FSDP_RES, FSDP_RES, 3).astype('f4'),
             'vfov': (rng.rand(B) * 2 - 1).astype('f4'),
             'pitch': (rng.rand(B) * 2 - 1).astype('f4'),
             'roll': (rng.rand(B) * 2 - 1).astype('f4')}
    jmodel = JaxCamCalib(backbone='resnet18', num_fc_layers=1)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(batch['img'])))
    return jmodel, variables, batch


def _jax_layout_steps(jmodel, variables, batch, mesh):
    """The JAX CamCalib step with its state laid out by
    ``fsdp_shardings`` on ``mesh`` (the reference FSDP test's jit):
    the losses of each step and the final state_dict."""
    import optax

    tx = optax.sgd(FSDP_LR, momentum=FSDP_MOMENTUM)
    step = jax_camcalib_step(jmodel, tx)
    st = jax_create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    st_sh = jpar.fsdp_shardings(st, mesh)
    jit = jax.jit(step, in_shardings=(st_sh, jpar.batch_sharding(mesh)),
                  out_shardings=(st_sh, jpar.replicated(mesh)))
    st = jpar.shard_like(st, st_sh)
    jb = jpar.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                          mesh)
    losses = []
    for _ in range(FSDP_STEPS):
        st, d = jit(st, jb)
        losses.append({k: float(v) for k, v in d.items()})
    return losses, state_dict_from_flax(
        {'params': jax.device_get(st.params),
         'batch_stats': jax.device_get(st.batch_stats)},
        'camcalib', 'resnet18')


def _spawn_ranks(world, d, env, *mode):
    port = _free_port()
    worker = os.path.join(ROOT, 'tests', 'mp_torch_worker.py')
    return [subprocess.Popen(
        [sys.executable, worker, str(r), str(world), str(port), str(d),
         *mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


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
    fmodel, fvars, fbatch = _fsdp_setup()
    torch.save(state_dict_from_flax(fvars, 'camcalib', 'resnet18'),
               d / 'fsdp_init.pt')
    np.savez(d / 'fsdp_batch.npz', **fbatch)

    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    procs = {world: _spawn_ranks(world, d, env) for world in (2, 4)}
    _make_train_data_root(d / 'val_data', np.random.RandomState(42), n=24)
    procs['val'] = _spawn_ranks(2, d, dict(
        env, SPEC_DATA_ROOT=str(d / 'val_data'),
        MP_LOGDIR=str(d / 'val_run')), 'val')
    logs = {}
    try:
        jlosses, jstate = _jax_mesh_steps(jmodel, variables, jassets, batch)
        jlayouts = {
            'fsdp': _jax_layout_steps(fmodel, fvars, fbatch,
                                      jpar.create_mesh(jax.devices()[:2])),
            'hsdp': _jax_layout_steps(fmodel, fvars, fbatch,
                                      jpar.create_hybrid_mesh(
                                          jax.devices()[:4], fsdp=2))}
        for world, ps in procs.items():
            logs[world] = [p.communicate(timeout=TIMEOUT)[0] for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for world, ps in procs.items():
        assert all(p.returncode == 0 for p in ps), '\n'.join(logs[world])
    outs = {world: [torch.load(d / f'w{world}_rank{r}.pt',
                               weights_only=False) for r in range(world)]
            for world in (2, 4)}
    return dict(dir=d, logs=logs[2], outs=outs[2], outs4=outs[4],
                val_logs=logs['val'],
                val=[torch.load(d / f'val_rank{r}.pt') for r in range(2)],
                batch=batch, jlosses=jlosses, jstate=jstate,
                jlayouts=jlayouts, cam_model=cam_model, cam_batch=cam_batch,
                trainer_model=trainer_model)


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


def _hold_layout(run, ranks, layout):
    """Each rank's ``layout`` run against the replicated run on the same
    ranks (LAYOUT_LOSS_RTOL, LAYOUT_PARAM_ATOL) and against the JAX
    step under the same layout (the step-parity limits); every rank's
    trace slots shaped as its slices. Returns each rank's run."""
    runs = [r['camcalib_layouts'][layout] for r in ranks]
    rep = [r['camcalib_layouts']['replicated'] for r in ranks]
    start = torch.load(run['dir'] / 'fsdp_init.pt')
    jlosses, jsd = run['jlayouts'][layout]
    for got, want in zip(runs, rep):
        assert got['losses'] == runs[0]['losses']   # global on every rank
        for g, w, j in zip(got['losses'], want['losses'], jlosses):
            for k, v in w.items():
                np.testing.assert_allclose(g[k], v, rtol=LAYOUT_LOSS_RTOL,
                                           err_msg=k)
            _hold_losses(g, j)
        for k, v in want['state'].items():
            torch.testing.assert_close(got['state'][k], v, rtol=0,
                                       atol=LAYOUT_PARAM_ATOL, msg=k)
        _hold_params(got['state'], jsd, start, layout)
    n_shard = len(ranks) if layout == 'fsdp' else 2
    for r in runs:
        assert any(d is not None for d in r['dims'])
        for dim, shape, slot in zip(r['dims'], r['shapes'], r['slots']):
            want = list(shape)
            if dim is not None:
                want[dim] //= n_shard
            assert list(slot.shape) == want, (dim, shape, slot.shape)
        assert r['slot_bytes'] < rep[0]['slot_bytes']
    # with the global-norm clip (whose norm sums the slices' squares over
    # the shard group) against the replicated run with it
    for r in ranks:
        got = r['camcalib_layouts'][f'{layout} clip']
        want = r['camcalib_layouts']['replicated clip']
        for g, w in zip(got['losses'], want['losses']):
            for k, v in w.items():
                np.testing.assert_allclose(g[k], v, rtol=LAYOUT_LOSS_RTOL,
                                           err_msg=k)
        for k, v in want['state'].items():
            torch.testing.assert_close(got['state'][k], v, rtol=0,
                                       atol=LAYOUT_PARAM_ATOL, msg=k)
        # the clip shrinks the update far below that limit: hold the
        # update itself, and check that the clip moved it
        assert _update_gap(got['state'], want['state'], start) <= \
            LAYOUT_UPDATE_RTOL
        assert _update_gap(want['state'], rep[0]['state'], start) > 0.1
    return runs


def _update_gap(a, b, start):
    """Relative L2 distance of two parameter updates from ``start`` (the
    BatchNorm statistics left out: they move without the optimizer)."""
    num = den = 0.0
    for k, v in b.items():
        if k.endswith(('num_batches_tracked', 'running_mean',
                       'running_var')):
            continue
        num += float(((a[k] - v).double() ** 2).sum())
        den += float(((v - start[k]).double() ** 2).sum())
    return (num / den) ** 0.5


def test_two_process_fsdp_camcalib_matches_replicated_and_jax(run):
    r0, r1 = run['outs']
    assert r0['fsdp_mesh'] == {'data': 2}
    runs = _hold_layout(run, run['outs'], 'fsdp')
    # the two ranks hold the two halves of each sharded slot
    for dim, a, b, full in zip(runs[0]['dims'], runs[0]['slots'],
                               runs[1]['slots'],
                               r0['camcalib_layouts']['replicated']['slots']):
        if dim is None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            torch.testing.assert_close(torch.cat([a, b], dim), full,
                                       rtol=0, atol=LAYOUT_PARAM_ATOL)


def test_four_process_hsdp_camcalib_matches_replicated_and_jax(run):
    ranks = run['outs4']
    assert ranks[0]['hsdp_mesh'] == {'data': 2, 'fsdp': 2}
    runs = _hold_layout(run, ranks, 'hsdp')
    sharded = [i for i, d in enumerate(runs[0]['dims']) if d is not None]
    # ranks 0 and 2 (one data group) hold the same slices; ranks 0 and 1
    # (one fsdp group) the two halves
    for i in sharded:
        torch.testing.assert_close(runs[0]['slots'][i], runs[2]['slots'][i],
                                   rtol=0, atol=0)
        torch.testing.assert_close(runs[1]['slots'][i], runs[3]['slots'][i],
                                   rtol=0, atol=0)
        assert not torch.equal(runs[0]['slots'][i], runs[1]['slots'][i])


def test_two_process_fsdp_trainer_preempt_resume(run):
    for out in run['outs']:
        assert out['fsdp_trainer_steps'] == [2, 3, 6, 6]
        assert out['fsdp_trainer_checks'] and all(
            out['fsdp_trainer_checks'].values()), out['fsdp_trainer_checks']
        assert out['fsdp_trainer_sharded'] > 0
        # Adam's two moments, about half of them on each rank
        assert out['fsdp_trainer_slot_bytes'] < \
            0.6 * out['plain_trainer_slot_bytes']
    assert 'FSDP over' in run['logs'][0]


# a small net's update under every rule, sharded against replicated: SGD
# (with momentum) is linear in the gradient, so it agrees to float32;
# Adam can turn the sums' order noise of a near-zero gradient into up to
# +-lr (1e-3 here) a step; this net's entries read at most 7.6e-7 (HSDP),
# and 2e-5 is 1 % of its two steps
RULE_ATOL = {'sgd': 1e-6, 'adam': 2e-5, 'adamw': 2e-5}


@pytest.mark.parametrize('world', [2, 4])
def test_update_rules_sharded_match_replicated(run, world):
    """Each rule with weight decay, the clip and GRAD_ACCUM_STEPS = 2 over
    two ranks (full-axis FSDP) and four (HSDP): the same losses, update
    count, parameters and whole slots as the replicated run, with the
    slots (the accumulator too) held at the slices' shapes."""
    for out in run['outs' if world == 2 else 'outs4']:
        runs = out['update_rules']
        for kind, atol in RULE_ATOL.items():
            got, want = runs[kind, 'sharded'], runs[kind, 'replicated']
            np.testing.assert_allclose(got['losses'], want['losses'],
                                       rtol=LAYOUT_LOSS_RTOL)
            assert got['count'] == want['count'] == 2.0
            for g, w in zip(got['params'], want['params']):
                torch.testing.assert_close(g, w, rtol=0, atol=atol)
            assert set(got['slots']) == set(want['slots']) >= {'acc'}
            for k in want['slots']:
                for g, w in zip(got['slots'][k], want['slots'][k]):
                    torch.testing.assert_close(g, w, rtol=0,
                                               atol=max(atol, 1e-6))
            # the two conv weights and the linear layer are sharded
            assert got['local']['acc'] != want['local']['acc']


def test_two_process_spec_eval_matches_one_process(run, monkeypatch):
    """Two ranks of the ``spec_eval`` CLI: the same metrics on both
    (rtol 1e-6) and as one process of the CLI (rtol 1e-5); exactly one
    LOGDIR under the log root holds the artifacts (the ranks agreed on
    rank 0's): one ``val_accuracy_results_*.json`` with a history of one
    entry and one ``evaluation_results_*.pkl``, written by rank 0."""
    import glob
    import json

    from spec_tpu_torch.cli import spec_eval

    r0, r1 = run['val']
    assert 'val_mpjpe' in r0 and sorted(r0) == sorted(r1)
    for k, v in r0.items():
        np.testing.assert_allclose(r1[k], v, rtol=1e-6, err_msg=k)
    root = str(run['dir'] / 'val_run')
    jsons = glob.glob(os.path.join(root, '**',
                                   'val_accuracy_results_*.json'),
                      recursive=True)
    pkls = glob.glob(os.path.join(root, '**', 'evaluation_results_*.pkl'),
                     recursive=True)
    assert len(jsons) == 1 and len(pkls) == 1, (jsons, pkls)
    assert os.path.dirname(jsons[0]) == os.path.dirname(pkls[0])
    with open(jsons[0]) as f:
        assert len(json.load(f)) == 1

    monkeypatch.setenv('SPEC_DATA_ROOT', str(run['dir'] / 'val_data'))
    ref = spec_eval.main(['--device', 'cpu', '--log_root',
                          str(run['dir'] / 'val_ref'), '--opts']
                         + VAL_OPTS)['3dpw-test-cam']
    assert sorted(ref) == sorted(r0)
    for k, v in r0.items():
        np.testing.assert_allclose(v, float(ref[k]), rtol=1e-5, err_msg=k)
