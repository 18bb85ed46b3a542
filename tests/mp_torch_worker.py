"""One rank of spec_tpu_torch's multi-process data-parallel run on the CPU
(gloo), spawned by ``tests/test_torch_multiprocess.py``.

Usage: ``python tests/mp_torch_worker.py RANK WORLD PORT DIR``. ``DIR``
holds the inputs the test wrote (``spec_init.pt``, ``spec_batch.npz``,
``camcalib_init.pt``, ``camcalib_batch.npz``, ``fsdp_init.pt``,
``fsdp_batch.npz``, the training set under ``train/``); each rank writes
``w{WORLD}_rank{RANK}.pt`` there. In order, with two ranks, it:

1. joins the process group over ``127.0.0.1:PORT`` and checks the
   agreements (``all_processes_any`` with a flag raised on rank 1 only,
   ``broadcast_string``);
2. runs ``SPEC_STEPS`` SPEC train steps on its slice of the global batch;
3. runs one CamCalib train step on its slice of another;
4. runs ``SpecTrainer`` for one epoch, preempted after one step (rank 0
   alone writes the checkpoint) and resumed on both ranks;
5. runs ``FSDP_STEPS`` CamCalib steps (SGD with momentum) replicated and
   then under full-axis FSDP, without and with the global-norm clip;
6. runs ``SpecTrainer`` with TRAINING.FSDP, preempted mid-epoch and
   resumed, then a plain trainer resuming its checkpoint and an FSDP one
   resuming the plain trainer's.

7. runs every update rule replicated and sharded on a small conv net
   (``update_rules``).

With four ranks it runs 1, then 5 and 7 under HSDP over a (2, 2) mesh.

``python tests/mp_torch_worker.py RANK WORLD PORT DIR val [DEVICE
[OPTS...]]`` instead runs the ``spec_eval`` CLI as one of WORLD ranks on
``DEVICE`` (default ``cpu``; its own cluster flags join the group over
gloo at ``127.0.0.1:PORT``, so ranks may share one card;
``SPEC_DATA_ROOT`` holds the val set, ``MP_LOGDIR`` is the log root,
``OPTS`` follow ``VAL_OPTS``) and writes its metrics to
``DIR/val_rank{RANK}.pt``. ``chip_smoke.py`` phase 26 runs it on the
card.

Imports torch and spec_tpu_torch only: no JAX.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

SPEC_STEPS = 3
LR = 1e-5
# the reference's FSDP test: two SGD steps at 1e-2 (momentum, so that the
# trace slot is sharded too)
FSDP_STEPS, FSDP_LR, FSDP_MOMENTUM = 2, 1e-2, 0.9
FSDP_CLIP = 1e-3      # below the gradient norm of these steps


# tests/test_multiprocess.py's two-process validation run
VAL_OPTS = ['DATASET.VAL_DS', '3dpw-test-cam', 'DATASET.BATCH_SIZE', '8',
            'DATASET.NUM_WORKERS', '1', 'DATASET.IMG_RES', '32',
            'HMR.BACKBONE', 'resnet18', 'TESTING.USE_GT_CAM', 'True']


def val_eval(rank, world, port, d, device='cpu', *opts):
    """Every rank evaluates the whole val set through the CLI; rank 0
    alone writes the artifacts, into rank 0's LOGDIR."""
    from spec_tpu_torch import parallel as par
    from spec_tpu_torch.cli import spec_eval

    res = spec_eval.main([
        '--device', device, '--dist_backend', 'gloo',
        '--coordinator_address', f'127.0.0.1:{port}',
        '--num_processes', str(world), '--process_id', str(rank),
        '--log_root', os.environ['MP_LOGDIR'], '--opts', *VAL_OPTS, *opts])
    torch.save({k: float(v) for k, v in res['3dpw-test-cam'].items()},
               os.path.join(d, f'val_rank{rank}.pt'))
    par.barrier()


def _slice(par, path):
    """This rank's slice of a saved global batch, as tensors."""
    batch = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    return par.shard_batch(batch, [torch.device('cpu')])[0]


def spec_steps(par, out, d):
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.train import adam, create_train_state
    from spec_tpu_torch.train import make_spec_train_step

    model = HMR(backbone='resnet18', use_cam_feats=True)
    model.load_state_dict(torch.load(os.path.join(d, 'spec_init.pt')))
    model.head.dropout_rate = 0.0
    state = create_train_state(model, adam(LR))
    step = make_spec_train_step(model,
                                S.create_test_assets(num_vertices=128))
    batch = _slice(par, os.path.join(d, 'spec_batch.npz'))
    out['spec_rows'] = len(batch['img'])
    out['spec_mode'] = step.mode
    out['spec_losses'] = []
    for _ in range(SPEC_STEPS):
        state, metrics = step(state, batch)
        out['spec_losses'].append({k: float(v)
                                   for k, v in metrics.items()})
    out['spec_state'] = {k: v.clone()
                         for k, v in model.state_dict().items()}


def camcalib_step(par, out, d):
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.train import adam, create_train_state
    from spec_tpu_torch.train import make_camcalib_train_step

    model = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
    model.load_state_dict(torch.load(os.path.join(d, 'camcalib_init.pt')))
    state = create_train_state(model, adam(LR))
    step = make_camcalib_train_step(
        model, loss_type='softargmax_biased_l2', vfov_loss_weight=10.0,
        pitch_loss_weight=10.0, roll_loss_weight=10.0)
    state, metrics = step(state, _slice(par, os.path.join(
        d, 'camcalib_batch.npz')))
    out['camcalib_losses'] = {k: float(v) for k, v in metrics.items()}
    out['camcalib_state'] = {k: v.clone()
                             for k, v in model.state_dict().items()}


class _StopAtStep:
    """SIGTERM stand-in: rank 0 alone asks to stop once the trainer
    reached ``at`` steps (the ranks must agree before the save)."""

    def __init__(self, trainer, at, rank):
        self.trainer, self.at, self.rank = trainer, at, rank

    @property
    def requested(self):
        return self.rank == 0 and self.trainer.state.step >= self.at


def _trainer_cfg(par, d, name, fsdp=False):
    from spec_tpu_torch.utils.config import spec_default_config

    cfg = spec_default_config()
    # each rank names its own LOGDIR; all take rank 0's
    cfg.LOGDIR = par.broadcast_string(
        os.path.join(d, f'{name}{par.process_index()}'))
    cfg.LOG_FREQ_TB_IMAGES = 0
    cfg.SEED_VALUE = 0
    cfg.HMR.BACKBONE = 'resnet18'
    cfg.OPTIMIZER.LR = LR
    cfg.DATASET.BATCH_SIZE = 2
    cfg.DATASET.NUM_WORKERS = 0
    cfg.DATASET.IMG_RES = 64
    cfg.TRAINING.LOG_SAVE_INTERVAL = 1
    cfg.TRAINING.MAX_EPOCHS = 1
    cfg.TRAINING.FSDP = fsdp
    return cfg


def _trainer(d, cfg, shift=0.0):
    """A SpecTrainer on the training set under ``d/train`` from
    ``trainer_init.pt`` (every weight plus ``shift``)."""
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.data.cam_dataset import (
        AugmentationConfig,
        CamDataset,
    )
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.train.trainer import SpecTrainer

    # The augmentations draw from one stream in fetch order, which a
    # rank's slice changes: with their effects off, the epoch is the same
    # as one process's.
    no_aug = AugmentationConfig(noise_factor=0.0, scale_factor=0.0,
                                use_motion_blur=False)
    assets = S.create_test_assets(num_vertices=128)
    train = os.path.join(d, 'train')
    model = HMR(backbone='resnet18')
    model.load_state_dict(torch.load(os.path.join(d, 'trainer_init.pt')))
    if shift:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(shift)
    model.head.dropout_rate = 0.0
    return SpecTrainer(
        cfg, model, {'neutral': assets}, assets.j_regressor_h36m.numpy(),
        lambda epoch: CamDataset(os.path.join(train, 'annots.npz'),
                                 os.path.join(train, 'imgs'), 'spec-syn',
                                 is_train=True, img_res=64, seed=epoch,
                                 aug=no_aug),
        dict)


def trainer_epoch(par, out, d):
    cfg = _trainer_cfg(par, d, 'run')
    t1 = _trainer(d, cfg)
    t1._fit(1, _StopAtStep(t1, 1, par.process_index()))
    out['preempted_at'] = t1.state.step
    t2 = _trainer(d, cfg)
    t2.resume()
    out['resumed_at'] = t2.state.step
    t2._fit(1, _StopAtStep(t2, 10 ** 6, 0))
    out['trainer_steps'] = t2.state.step
    out['trainer_logdir'] = cfg.LOGDIR
    out['trainer_state'] = {k: v.clone()
                            for k, v in t2.model.state_dict().items()}


def camcalib_layouts(par, out, d):
    """``FSDP_STEPS`` CamCalib steps on this rank's slice of the
    reference FSDP test's batch, replicated and then sharded: full-axis
    FSDP with two ranks, HSDP over a (2, 2) mesh with four."""
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.train import create_train_state
    from spec_tpu_torch.train import make_camcalib_train_step
    from spec_tpu_torch.train.state import Transform

    batch = _slice(par, os.path.join(d, 'fsdp_batch.npz'))
    runs = {}
    sharded = 'fsdp' if par.process_count() == 2 else 'hsdp'
    # and both again with the global-norm clip (its norm sums the
    # slices' squares over the shard group)
    for layout, clip in (('replicated', 0.0), (sharded, 0.0),
                         ('replicated', FSDP_CLIP), (sharded, FSDP_CLIP)):
        model = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
        model.load_state_dict(torch.load(os.path.join(d, 'fsdp_init.pt')))
        state = create_train_state(model, Transform(
            'sgd', FSDP_LR, momentum=FSDP_MOMENTUM, clip_norm=clip))
        opt = state.optimizer
        dims = [None] * len(opt.params)
        if layout != 'replicated':
            mesh = (par.create_hybrid_mesh(fsdp=2) if layout == 'hsdp'
                    else par.create_process_mesh())
            shardings = par.fsdp_shardings(opt.params, mesh)
            par.shard_like(state, shardings)
            dims = [None if s is None else s.dim for s in shardings]
            out[f'{layout}_mesh'] = mesh.shape
        step = make_camcalib_train_step(model)
        losses = []
        for _ in range(FSDP_STEPS):
            state, metrics = step(state, batch)
            losses.append({k: float(v) for k, v in metrics.items()})
        runs[layout + (' clip' if clip else '')] = {
            'losses': losses, 'dims': dims,
            'shapes': [tuple(p.shape) for p in opt.params],
            'slots': [t.clone() for t in opt.slots['trace']],
            'slot_bytes': opt.slot_bytes(),
            'state': {k: v.clone() for k, v in model.state_dict().items()}}
    out['camcalib_layouts'] = runs


def update_rules(par, out, d):
    """Every update rule on a small conv net, replicated and sharded
    (full-axis with two ranks, HSDP with four), each with weight decay,
    the global-norm clip and GRAD_ACCUM_STEPS = 2 (the accumulator slot
    sharded too): four micro-batches, two updates."""
    from spec_tpu_torch.train import create_train_state
    from spec_tpu_torch.train.state import Transform
    from spec_tpu_torch.train.steps import TrainStep

    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 3, 10, 10, generator=g)
    y = torch.randn(8, 4, generator=g)
    batch = par.shard_batch({'x': x, 'y': y}, [torch.device('cpu')])[0]

    def loss_fn(model, generator, b):
        loss = par.batch_mean(((model(b['x']) - b['y']) ** 2).sum(1))
        return loss, {'loss': loss}

    runs = {}
    for kind in ('sgd', 'adam', 'adamw'):
        for layout in ('replicated', 'sharded'):
            torch.manual_seed(0)
            model = torch.nn.Sequential(
                torch.nn.Conv2d(3, 64, 3), torch.nn.ReLU(),
                torch.nn.Conv2d(64, 128, 3), torch.nn.Flatten(),
                torch.nn.Linear(128 * 36, 4))
            state = create_train_state(model, Transform(
                kind, 1e-3, weight_decay=1e-2, clip_norm=0.5, every_k=2,
                momentum=0.9 if kind == 'sgd' else None))
            if layout == 'sharded':
                mesh = (par.create_process_mesh() if par.process_count() == 2
                        else par.create_hybrid_mesh(fsdp=2))
                par.shard_like(state, par.fsdp_shardings(
                    state.optimizer.params, mesh, min_size=1024))
            step = TrainStep('rules', lambda b: ('x', 'y'), loss_fn)
            losses = []
            for _ in range(4):
                state, metrics = step(state, batch)
                losses.append(float(metrics['loss']))
            opt = state.optimizer
            runs[kind, layout] = {
                'losses': losses, 'count': float(opt.count),
                'params': [p.detach().clone() for p in model.parameters()],
                'slots': opt.state_dict()['slots'],
                'local': {k: [tuple(t.shape) for t in v]
                          for k, v in opt.slots.items()}}
    out['update_rules'] = runs


def _same(a: dict, b: dict) -> bool:
    """Two state_dicts (or optimizer states), bit for bit."""
    if set(a) != set(b):
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, dict):
            if not _same(v, w):
                return False
        elif isinstance(v, list):
            if len(v) != len(w) or not all(torch.equal(x, y)
                                           for x, y in zip(v, w)):
                return False
        elif isinstance(v, torch.Tensor):
            if not torch.equal(v, w):
                return False
        elif v != w:
            return False
    return True


def _snapshot(t) -> tuple:
    """(the model's state_dict, the optimizer's whole state): the second
    gathers sharded slots, so every rank calls it."""
    return ({k: v.clone() for k, v in t.model.state_dict().items()},
            t.state.optimizer.state_dict())


def trainer_fsdp(par, out, d):
    """SpecTrainer with TRAINING.FSDP over both ranks: preempted after
    two of the epoch's three steps and resumed in a trainer built from
    other weights, which must restore the preempted model and optimizer
    state bit for bit, keep the layout and finish the epoch; then a
    plain trainer resumes that FSDP checkpoint and trains an epoch, and
    an FSDP trainer resumes the plain one's, each bit for bit."""
    rank = par.process_index()
    fsdp_cfg = _trainer_cfg(par, d, 'fsdp_run', fsdp=True)
    plain_cfg = fsdp_cfg.clone()
    plain_cfg.TRAINING.FSDP = False
    checks = {}
    t1 = _trainer(d, fsdp_cfg)
    t1._fit(1, _StopAtStep(t1, 2, rank))
    preempted = _snapshot(t1)
    t2 = _trainer(d, fsdp_cfg, shift=1.0)
    checks['a fresh trainer starts elsewhere'] = not _same(
        _snapshot(t2)[0], preempted[0])
    t2.resume()
    got = _snapshot(t2)
    checks['FSDP resume: model'] = _same(got[0], preempted[0])
    checks['FSDP resume: optimizer'] = _same(got[1], preempted[1])
    opt = t2.state.optimizer
    checks['FSDP resume: layout'] = opt.layout is not None and all(
        tuple(s.shape) == tuple(t.shape)
        for ts in opt.slots.values()
        for s, t in zip(ts, opt.layout.local)) and any(
        t.numel() < p.numel() for t, p in zip(opt.slots['mu'], opt.params))
    out['fsdp_trainer_slot_bytes'] = opt.slot_bytes()
    out['fsdp_trainer_sharded'] = len(opt.layout.sharded)
    t2._fit(1, _StopAtStep(t2, 10 ** 6, 0))
    fsdp_end = _snapshot(t2)
    t3 = _trainer(d, plain_cfg, shift=1.0)
    t3.resume()
    checks['plain resumes the FSDP checkpoint'] = (
        t3.state.optimizer.layout is None and t3.state.step == t2.state.step
        and _same(_snapshot(t3)[0], fsdp_end[0])
        and _same(_snapshot(t3)[1], fsdp_end[1]))
    t3._fit(2, _StopAtStep(t3, 10 ** 6, 0))
    plain_end = _snapshot(t3)
    out['plain_trainer_slot_bytes'] = t3.state.optimizer.slot_bytes()
    t4 = _trainer(d, fsdp_cfg, shift=1.0)
    t4.resume()
    checks['FSDP resumes the plain checkpoint'] = (
        t4.state.optimizer.layout is not None
        and t4.state.step == t3.state.step
        and _same(_snapshot(t4)[0], plain_end[0])
        and _same(_snapshot(t4)[1], plain_end[1]))
    out['fsdp_trainer_checks'] = checks
    out['fsdp_trainer_steps'] = [t1.state.step, t2.state.step,
                                 t3.state.step, t4.state.step]


def main():
    rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    # no TensorBoard writer (its import takes seconds; not checked here)
    sys.modules['torch.utils.tensorboard'] = None
    if sys.argv[5:6] == ['val']:
        val_eval(rank, world, port, d, *sys.argv[6:])
        print(f'[rank {rank}] DONE', flush=True)
        return
    from spec_tpu_torch import parallel as par

    par.initialize_multihost(f'127.0.0.1:{port}', world, rank,
                             device='cpu')
    assert (par.process_index(), par.process_count()) == (rank, world)
    out = {'backend': par.backend(),
           'any_rank1': par.all_processes_any(rank == 1),
           'any_none': par.all_processes_any(False),
           'string': par.broadcast_string(f'logs/rank{rank}')}
    parts = ((spec_steps, camcalib_step, trainer_epoch, camcalib_layouts,
              trainer_fsdp, update_rules) if world == 2
             else (camcalib_layouts, update_rules))
    for part in parts:
        t0 = time.perf_counter()
        part(par, out, d)
        print(f'[rank {rank}] {part.__name__}: '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    torch.save(out, os.path.join(d, f'w{world}_rank{rank}.pt'))
    par.barrier()
    print(f'[rank {rank}] DONE', flush=True)


if __name__ == '__main__':
    main()
