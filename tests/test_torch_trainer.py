"""spec_tpu_torch.train.trainer.SpecTrainer against spec_tpu's on the same
synthetic scenario, on the CPU.

Both trainers get the same config (ResNet-18 HMR, batches of 2 crops of
64², ``adam(1e-5)``, validation every epoch on the eval fixture of
tests/test_goldens.py), the same starting weights (the JAX PRNGKey(0)
init, bridged) and the same datasets (``CamDataset(is_train=True)``,
seeded per epoch; the JAX one on its cv2 path). Dropout is off on both
sides (a test-local monkeypatch of ``flax.linen.Dropout`` and p = 0),
so the runs can be compared number for number.

The scenario: a first run preempted (the stop flag set before the 5th
batch, in epoch 1) after a validated epoch 0; a second run in a sibling
log directory that resumes from it (epoch 1, skipping the consumed
batch) and finishes epoch 1. Compared: ``meta.json`` (epochs, skips,
the ranked list with its directories mapped), the step directories
left, the resume epoch and skip, the steps, ``val_accuracy_results``
(metrics within 1e-3 relative, VAL_RTOL: the trained weights differ by
the steps' float noise), and what the six steps trained: the final
weights less the starting ones, against the JAX run's. The update is
held, not the weights: after six steps at lr 1e-5 the weights move by
about as much as a limit on them would allow. Over the whole model the
update is within 1e-3 relative (UPDATE_RTOL; read: 1.07e-4), so a
trainer that lost a step (off by about 1/6) or resumed from the
starting weights (about 4/6) fails; each tensor's within 0.3
(TENSOR_UPDATE_RTOL; read: at most 0.078, a 128-entry BN scale, whose
entries with rounding-noise gradients Adam moves by +-lr either way),
so a missing, halved or reversed update of any tensor fails.
Separately: ranked pruning with keep = 2, NaN metrics skipped; the NaN
guard; ``resume`` with ``wo_optimizer``; the fail-fast checks; the
TensorBoard mesh grid (``LOG_FREQ_TB_IMAGES``) against the JAX
trainer's on one batch (GRID_LEVELS), and written by ``fit``.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.data.cam_dataset import CamDataset as JaxCamDataset
from spec_tpu.data.loader import DataLoader as JaxDataLoader
from spec_tpu.models import HMR as JaxHMR
from spec_tpu.train import trainer as JTR
from spec_tpu.utils import preemption as JP
from spec_tpu.utils.config import spec_default_config as jax_config
from spec_tpu_torch.data.cam_dataset import CamDataset
from spec_tpu_torch.data.loader import DataLoader
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.train import trainer as TTR
from spec_tpu_torch.utils import preemption as TP
from spec_tpu_torch.utils.checkpoints import (
    assets_from_jax,
    latest_step,
    state_dict_from_flax,
)
from spec_tpu_torch.utils.config import spec_default_config
from tests.test_goldens import _write_eval_fixture
from tests.test_torch_train_data import write_train_set

VAL_RTOL = 1e-3
UPDATE_RTOL, TENSOR_UPDATE_RTOL = 1e-3, 0.3
V, RES, BATCH = 128, 64, 2
# The mesh grid, [0, 1] floats: the models' vertices agree to ~1e-6 m,
# so a few edge pixels may flip; mean difference and share of pixels
# more than 0.05 apart.
GRID_LEVELS = dict(mean=1e-3, far_share=2e-3)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(make, logdir, **over):
    cfg = make()
    cfg.LOGDIR = str(logdir)
    cfg.LOG_FREQ_TB_IMAGES = 0
    cfg.SEED_VALUE = 0
    cfg.HMR.BACKBONE = 'resnet18'
    cfg.OPTIMIZER.LR = 1e-5
    cfg.DATASET.BATCH_SIZE = BATCH
    cfg.DATASET.NUM_WORKERS = 0
    cfg.DATASET.IMG_RES = RES
    cfg.DATASET.VAL_DS = '3dpw-test-cam'
    cfg.TRAINING.LOG_SAVE_INTERVAL = 2
    cfg.TRAINING.MAX_EPOCHS = 2
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split('.')
        for p in path:
            node = node[p]
        node[leaf] = v
    return cfg


class _StopAt:
    """GracefulShutdown stand-in: ``requested`` turns true at the n-th
    time the loop reads it (each trainer reads it once per batch)."""

    n = None

    def __init__(self, *a, **k):
        self.reads = 0

    @property
    def requested(self):
        self.reads += 1
        return _StopAt.n is not None and self.reads >= _StopAt.n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(autouse=True)
def one_device_mesh(monkeypatch):
    """The JAX trainer on one CPU device (the suite's conftest makes
    eight; the port drives one device)."""
    make = JTR.par.create_mesh
    monkeypatch.setattr(JTR.par, 'create_mesh',
                        lambda devices=None, **kw: make(jax.devices()[:1],
                                                        **kw))


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('trainer')
    annot, img_dir = write_train_set(str(root / 'train'))
    val_annot, val_dir = _write_eval_fixture(str(root / 'val'))
    jassets = JS.create_test_assets(num_vertices=V)
    jmodel = JaxHMR(backbone='resnet18', use_cam=True)
    eye = jnp.tile(jnp.eye(3), (1, 1, 1))
    variables = jmodel.init(jax.random.PRNGKey(0), jassets,
                            jnp.zeros((1, RES, RES, 3)), eye, eye,
                            jnp.ones((1,)), jnp.ones((1, 2)), jnp.ones((1,)),
                            jnp.ones((1,)))
    return dict(root=root, annot=annot, img_dir=img_dir,
                val_annot=val_annot, val_dir=val_dir, jassets=jassets,
                jmodel=jmodel, variables=jax.device_get(variables),
                jreg=np.asarray(jassets.j_regressor_h36m))


def _jax_trainer(world, cfg, annot=None):
    annot = annot or world['annot']

    def make_train(epoch):
        return JaxCamDataset(annot, world['img_dir'], 'spec-syn',
                             is_train=True, img_res=RES, seed=epoch,
                             native_decode=False)

    def make_val():
        ds = JaxCamDataset(world['val_annot'], world['val_dir'],
                           '3dpw-test-cam', native_decode=False)
        return {'3dpw-test-cam': JaxDataLoader(ds, batch_size=BATCH)}

    return JTR.SpecTrainer(cfg, world['jmodel'],
                           {'neutral': world['jassets']}, world['jreg'],
                           make_train, make_val,
                           # a copy: the JAX step donates its state
                           init_variables=jax.tree.map(jnp.asarray,
                                                       world['variables']))


def _port_trainer(world, cfg, annot=None):
    annot = annot or world['annot']
    model = HMR(backbone='resnet18')
    model.load_state_dict(state_dict_from_flax(world['variables'], 'hmr',
                                               'resnet18'))
    model.head.dropout_rate = 0.0

    def make_train(epoch):
        return CamDataset(annot, world['img_dir'], 'spec-syn',
                          is_train=True, img_res=RES, seed=epoch)

    def make_val():
        ds = CamDataset(world['val_annot'], world['val_dir'],
                        '3dpw-test-cam')
        return {'3dpw-test-cam': DataLoader(ds, batch_size=BATCH)}

    return TTR.SpecTrainer(cfg, model,
                           {'neutral': assets_from_jax(world['jassets'])},
                           world['jreg'], make_train, make_val)


def _meta(logdir, root):
    with open(os.path.join(logdir, 'checkpoints', 'meta.json')) as f:
        meta = json.load(f)
    meta['ranked'] = [[v, s, os.path.relpath(d, root)]
                      for v, s, d in meta['ranked']]
    return meta


def _steps(logdir):
    return sorted(os.listdir(os.path.join(logdir, 'checkpoints')))


def _hold_meta(got, want):
    assert got['epochs'] == want['epochs']
    assert got['skip'] == want['skip']
    assert [r[1:] for r in got['ranked']] == [r[1:] for r in want['ranked']]
    np.testing.assert_allclose([r[0] for r in got['ranked']],
                               [r[0] for r in want['ranked']],
                               rtol=VAL_RTOL)


def _hold_val_json(got_dir, want_dir):
    name = 'val_accuracy_results_3dpw-test-cam.json'
    with open(os.path.join(got_dir, name)) as f:
        got = json.load(f)
    with open(os.path.join(want_dir, name)) as f:
        want = json.load(f)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) and g['epoch'] == w['epoch']
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=VAL_RTOL, err_msg=k)


def _update_rel(got, want, init):
    """The trained update, got - init against want - init: relative L2
    error over the whole model, and the worst tensor's (error, name)."""
    num = den = 0.0
    worst = (0.0, None)
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        ug, uw = ((t.double() - init[k].double()) for t in (got[k], w))
        e2, w2 = float(((ug - uw) ** 2).sum()), float((uw ** 2).sum())
        num, den = num + e2, den + w2
        worst = max(worst, ((e2 / max(w2, 1e-300)) ** 0.5, k))
    return (num / den) ** 0.5, worst


def test_preempt_resume_matches_jax(world, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, '__call__',
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(JP, 'GracefulShutdown', _StopAt)
    monkeypatch.setattr(TP, 'GracefulShutdown', _StopAt)
    root = world['root']
    runs = {}
    for side, make_cfg, make in (('jax', jax_config, _jax_trainer),
                                 ('port', spec_default_config,
                                  _port_trainer)):
        first = root / side / 'run0'
        _StopAt.n = 5                # epoch 0 has 3 batches
        trainer = make(world, _cfg(make_cfg, first))
        trainer.fit()
        runs[side, 'first'] = (first, trainer)
        second = root / side / 'run1'
        _StopAt.n = None
        trainer = make(world, _cfg(make_cfg, second))
        trainer.resume()
        runs[side, 'resumed'] = (
            trainer._resume_epoch, trainer._resume_skip,
            int(trainer.state.step))
        trainer.fit()
        runs[side, 'second'] = (second, trainer)

    (jfirst, _), (tfirst, _) = runs['jax', 'first'], runs['port', 'first']
    _hold_meta(_meta(tfirst, root / 'port'), _meta(jfirst, root / 'jax'))
    assert _steps(tfirst) == _steps(jfirst) == [
        'meta.json', 'step_00000003', 'step_00000004']
    assert runs['port', 'resumed'] == runs['jax', 'resumed'] == (1, 1, 4)
    (jsecond, jtr), (tsecond, ttr) = (runs['jax', 'second'],
                                      runs['port', 'second'])
    _hold_meta(_meta(tsecond, root / 'port'), _meta(jsecond, root / 'jax'))
    assert _steps(tsecond) == _steps(jsecond) == [
        'meta.json', 'step_00000006']
    assert int(ttr.state.step) == int(jtr.state.step) == 6
    _hold_val_json(tfirst, jfirst)
    _hold_val_json(tsecond, jsecond)
    want = state_dict_from_flax(
        {'params': jax.device_get(jtr.state.params),
         'batch_stats': jax.device_get(jtr.state.batch_stats)},
        'hmr', 'resnet18')
    init = state_dict_from_flax(world['variables'], 'hmr', 'resnet18')
    whole, worst = _update_rel(ttr.model.state_dict(), want, init)
    assert whole <= UPDATE_RTOL, whole
    assert worst[0] <= TENSOR_UPDATE_RTOL, worst


def test_prune_ranked_matches_jax(world, tmp_path):
    """keep = 2 over five checkpoints with one NaN metric: the same step
    directories are left and the same ranking is kept."""
    left = {}
    for side, make_cfg, make in (('jax', jax_config, _jax_trainer),
                                 ('port', spec_default_config,
                                  _port_trainer)):
        trainer = make(world, _cfg(make_cfg, tmp_path / side))
        for step in (1, 2, 3, 4, 5):
            os.makedirs(os.path.join(trainer.ckpt_dir, f'step_{step:08d}'))
        for step, metric in ((1, 50.0), (2, 40.0), (3, float('nan')),
                             (4, 45.0), (5, 60.0)):
            trainer._prune_ranked(metric, step, keep=2)
        left[side] = (_steps(tmp_path / side),
                      [b[:2] for b in trainer.best])
    assert left['port'] == left['jax']
    assert left['port'][0] == ['step_00000002', 'step_00000003',
                               'step_00000004']


def test_nan_guard_matches_jax(world, tmp_path):
    """A non-finite loss stops training at the next log interval."""
    npz = dict(np.load(world['annot']))
    npz['S'][:, :, 0] = np.nan
    bad = str(tmp_path / 'bad.npz')
    np.savez(bad, **npz)
    for side, make_cfg, make in (('jax', jax_config, _jax_trainer),
                                 ('port', spec_default_config,
                                  _port_trainer)):
        trainer = make(world, _cfg(make_cfg, tmp_path / side), annot=bad)
        with pytest.raises(FloatingPointError, match='non-finite loss at '
                                                     'step 2'):
            trainer.fit(max_epochs=1)


def test_resume_without_optimizer_and_fail_fast(world, tmp_path,
                                                monkeypatch):
    cfg = _cfg(spec_default_config, tmp_path / 'a')
    trainer = _port_trainer(world, cfg)
    trainer.fit(max_epochs=1)
    assert latest_step(trainer.ckpt_dir) == 3
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    fresh = _port_trainer(world, _cfg(spec_default_config, tmp_path / 'b'))
    fresh.resume(wo_optimizer=True)
    assert fresh.state.step == 0 and fresh._resume_epoch == 0
    assert float(fresh.state.optimizer.count) == 0.0
    for k, v in fresh.model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    nothing = _port_trainer(world, _cfg(spec_default_config,
                                        tmp_path / 'x' / 'lone'))
    nothing.resume()                      # warns, starts from scratch
    assert nothing.state.step == 0
    # TRAINING.FSDP is ported (tests/test_torch_multiprocess.py): in one
    # process the layout is full-axis over one rank, every large leaf's
    # slice the whole leaf; the trainer refuses what the reference's
    # refuses, with its exception types
    fsdp = _port_trainer(world, _cfg(spec_default_config, tmp_path / 'c',
                                     **{'TRAINING.FSDP': True}))
    layout = fsdp.state.optimizer.layout
    assert fsdp.mesh.shape == {'data': 1} and layout.sharded
    assert all(t.shape == p.shape for t, p in zip(layout.local,
                                                  layout.params))
    with pytest.raises(ValueError, match='not divisible by fsdp=2'):
        _port_trainer(world, _cfg(spec_default_config, tmp_path / 'c',
                                  **{'TRAINING.FSDP': True,
                                     'TRAINING.FSDP_GROUP_SIZE': 2}))
    monkeypatch.setenv('WORLD_SIZE', '4')
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')
    with pytest.raises(SystemExit, match='within-host groups'):
        _port_trainer(world, _cfg(spec_default_config, tmp_path / 'c',
                                  **{'TRAINING.FSDP': True}))
    monkeypatch.delenv('WORLD_SIZE')
    monkeypatch.delenv('LOCAL_WORLD_SIZE')
    # RUN_SMPLIFY and REMAT are ported (tests/test_torch_smplify.py,
    # tests/test_torch_remat.py): the first builds, the second refuses a
    # model built without remat
    assert _port_trainer(world, _cfg(
        spec_default_config, tmp_path / 'c',
        **{'TRAINING.RUN_SMPLIFY': True})).cfg.TRAINING.RUN_SMPLIFY
    with pytest.raises(ValueError, match='TRAINING.REMAT'):
        _port_trainer(world, _cfg(spec_default_config, tmp_path / 'c',
                                  **{'TRAINING.REMAT': True}))
    # TensorBoard image grids are ported (test_tb_image_grid_matches_jax)
    assert _port_trainer(world, _cfg(spec_default_config, tmp_path / 'd',
                                     LOG_FREQ_TB_IMAGES=500)).writer
    with pytest.raises(SystemExit, match='in-the-wild'):
        _port_trainer(world, _cfg(spec_default_config, tmp_path / 'e',
                                  **{'DATASET.VAL_DS': 'coco'}))
    assert TTR.parse_schedule('0+a_b_0.5_0.5 5+c_1.0') == \
        JTR.parse_schedule('0+a_b_0.5_0.5 5+c_1.0')
    for bad in ('5c', '+a', 'x+y'):
        with pytest.raises(ValueError):
            TTR.parse_schedule(bad)


@pytest.fixture
def cli_data_root(world, tmp_path, monkeypatch):
    """A data root holding the synthetic train set as the registry's
    spec-syn and the eval fixture as its 3dpw-test-cam."""
    import shutil

    root = tmp_path / 'data'
    (root / 'dataset_extras').mkdir(parents=True)
    shutil.copy(world['annot'],
                root / 'dataset_extras' / 'spec-syn_camcalib.npz')
    shutil.copytree(world['img_dir'], root / 'dataset_folders' / 'spec-syn')
    shutil.copy(world['val_annot'],
                root / 'dataset_extras' / '3dpw_test_cam_camcalib.npz')
    shutil.copytree(world['val_dir'], root / 'dataset_folders' / '3dpw')
    monkeypatch.setenv('SPEC_DATA_ROOT', str(root))
    cfg = tmp_path / 'train.yaml'
    cfg.write_text(
        'LOG_FREQ_TB_IMAGES: 0\nSEED_VALUE: 0\n'
        'HMR:\n  BACKBONE: resnet18\n'
        'DATASET:\n  BATCH_SIZE: 2\n  NUM_WORKERS: 1\n  IMG_RES: 64\n'
        '  VAL_DS: 3dpw-test-cam\n'
        'TRAINING:\n  LOG_SAVE_INTERVAL: 1\n')
    return root, str(cfg)


def test_spec_train_cli_fdr_then_spec_eval_reads_the_checkpoint(
        cli_data_root, tmp_path, capsys, monkeypatch):
    """``spec_train --device cpu --fdr``: one epoch, a validation, a
    checkpoint that ``spec_eval --ckpt`` loads; ``--resume`` in a new
    run continues from it. Its flags are the reference CLI's plus
    ``--device``."""
    from spec_tpu.cli import spec_train as jax_cli
    from spec_tpu_torch.cli import spec_eval as TEval
    from spec_tpu_torch.cli import spec_train as TTrain

    _, cfg = cli_data_root
    log_root = str(tmp_path / 'logs')
    trainer = TTrain.main(['--cfg', cfg, '--log_root', log_root, '--fdr',
                           '--device', 'cpu'])
    assert trainer.state.step == 3
    ckpt = trainer.ckpt_dir
    assert latest_step(ckpt) == 3
    assert os.path.exists(os.path.join(
        trainer.cfg.LOGDIR, 'val_accuracy_results_3dpw-test-cam.json'))
    model = TEval.build_model(trainer.cfg, ckpt, torch.device('cpu'))
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    resumed = TTrain.main(['--cfg', cfg, '--log_root', log_root, '--fdr',
                           '--resume', '--device', 'cpu'])
    assert resumed.state.step == 3 and resumed._resume_epoch == 1
    assert 'resumed from step 3' in capsys.readouterr().out

    import argparse

    captured = {}

    def grab(self, *a, **k):
        captured['parser'] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', grab)
    with pytest.raises(SystemExit):
        jax_cli.main([])
    monkeypatch.undo()
    ref = {a.dest for a in captured['parser']._actions}
    port = {a.dest for a in TTrain.build_parser()._actions}
    # --dist_backend: the process group's backend (gloo for ranks that
    # share one card)
    assert port == ref | {'device', 'dist_backend'}


def test_spec_train_cli_needs_a_card_or_cpu(monkeypatch, tmp_path):
    from spec_tpu_torch.cli import spec_train as TTrain

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        TTrain.main(['--log_root', str(tmp_path)])
    assert e.value.code not in (0, None) and 'device cpu' in str(e.value)
    assert not (tmp_path / 'spec_train.py').exists()
    # the multi-process flags are ported: each needs the others
    for flags in (['--coordinator_address', 'localhost:1'],
                  ['--num_processes', '2'], ['--process_id', '0']):
        with pytest.raises(ValueError, match='--num_processes'):
            TTrain.main(flags + ['--device', 'cpu'])


def test_preemption_and_profiling_helpers():
    """GracefulShutdown latches SIGTERM and restores the handler;
    StepTimer and set_seed behave as the JAX package's."""
    import signal

    from spec_tpu.utils.profiling import StepTimer as JaxTimer
    from spec_tpu_torch.utils.profiling import StepTimer, set_seed

    before = signal.getsignal(signal.SIGTERM)
    with TP.GracefulShutdown() as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested
    assert signal.getsignal(signal.SIGTERM) == before
    timers = [StepTimer(), JaxTimer()]
    for timer in timers:
        with timer('load'):
            pass
        assert set(timer.as_dict()) == {'load'} and timer.mean('x') != 0
        assert timer.report().startswith('load ')
    gen = set_seed(3)
    a = np.random.rand()
    np.random.seed(3)
    assert a == np.random.rand()
    assert torch.equal(torch.rand(2, generator=gen),
                       torch.rand(2, generator=torch.Generator()
                                  .manual_seed(3)))
    assert set_seed(-1).initial_seed() == 0


class _Images:
    """A SummaryWriter stand-in that keeps the images."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, np.asarray(img), step))


def test_tb_image_grid_matches_jax(world, tmp_path, tmp_path_factory,
                                   monkeypatch):
    """``_train_image_summary`` on one loader batch from the same
    weights: the port's grid against the JAX trainer's (crop-frame
    intrinsics, 4 samples x [crop | overlay | 3 side views]); then ``fit``
    with LOG_FREQ_TB_IMAGES = 2 writes ``train/mesh_grid`` to the event
    file."""
    import spec_tpu.native as JN

    monkeypatch.setattr(JN, '_SO', str(tmp_path_factory.mktemp('jn')
                                       / '_native.so'))
    monkeypatch.setattr(JN, '_lib', None)
    monkeypatch.setattr(JN, '_failed', False)
    ds = CamDataset(world['annot'], world['img_dir'], 'spec-syn',
                    is_train=True, img_res=RES, seed=0)
    batch = next(iter(DataLoader(ds, batch_size=4)))
    grids = {}
    for side, make_cfg, make in (('jax', jax_config, _jax_trainer),
                                 ('port', spec_default_config,
                                  _port_trainer)):
        trainer = make(world, _cfg(make_cfg, tmp_path / side))
        trainer.writer = _Images()
        trainer._train_image_summary(batch, 7)
        (tag, img, step), = trainer.writer.images
        assert (tag, step) == ('train/mesh_grid', 7)
        grids[side] = img
    got, want = grids['port'], grids['jax']
    assert got.shape == want.shape == (3, 4 * RES, 5 * RES)
    d = np.abs(got - want)
    assert d.mean() <= GRID_LEVELS['mean'], d.mean()
    assert (d > 0.05).any(0).mean() <= GRID_LEVELS['far_share']
    assert (got[:, :, RES:] != 0).any()          # meshes drawn

    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    trainer = _port_trainer(world, _cfg(spec_default_config,
                                        tmp_path / 'fit',
                                        LOG_FREQ_TB_IMAGES=2))
    trainer.fit(max_epochs=1)
    acc = EventAccumulator(str(tmp_path / 'fit' / 'tb_logs'))
    acc.Reload()
    assert 'train/mesh_grid' in acc.Tags()['images']
    assert [e.step for e in acc.Images('train/mesh_grid')] == [2]
