"""One rank of spec_tpu_torch's multi-process data-parallel run on the CPU
(gloo), spawned by ``tests/test_torch_multiprocess.py``.

Usage: ``python tests/mp_torch_worker.py RANK WORLD PORT DIR``. ``DIR``
holds the inputs the test wrote (``spec_init.pt``, ``spec_batch.npz``,
``camcalib_init.pt``, ``camcalib_batch.npz``, the training set under
``train/``); each rank writes ``rank{RANK}.pt`` there. In order, it:

1. joins the process group over ``127.0.0.1:PORT`` and checks the
   agreements (``all_processes_any`` with a flag raised on rank 1 only,
   ``broadcast_string``);
2. runs ``SPEC_STEPS`` SPEC train steps on its slice of the global batch;
3. runs one CamCalib train step on its slice of another;
4. runs ``SpecTrainer`` for one epoch, preempted after one step (rank 0
   alone writes the checkpoint) and resumed on both ranks.

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


def trainer_epoch(par, out, d):
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.data.cam_dataset import (
        AugmentationConfig,
        CamDataset,
    )
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils.config import spec_default_config

    # The augmentations draw from one stream in fetch order, which a
    # rank's slice changes: with their effects off, the epoch is the same
    # as one process's.
    NO_AUG = AugmentationConfig(noise_factor=0.0, scale_factor=0.0,
                                use_motion_blur=False)
    cfg = spec_default_config()
    # each rank names its own LOGDIR; all take rank 0's
    cfg.LOGDIR = par.broadcast_string(
        os.path.join(d, f'run{par.process_index()}'))
    cfg.LOG_FREQ_TB_IMAGES = 0
    cfg.SEED_VALUE = 0
    cfg.HMR.BACKBONE = 'resnet18'
    cfg.OPTIMIZER.LR = LR
    cfg.DATASET.BATCH_SIZE = 2
    cfg.DATASET.NUM_WORKERS = 0
    cfg.DATASET.IMG_RES = 64
    cfg.TRAINING.LOG_SAVE_INTERVAL = 1
    cfg.TRAINING.MAX_EPOCHS = 1
    assets = S.create_test_assets(num_vertices=128)
    jreg = assets.j_regressor_h36m.numpy()
    train = os.path.join(d, 'train')

    def make():
        model = HMR(backbone='resnet18')
        model.load_state_dict(torch.load(os.path.join(d,
                                                      'trainer_init.pt')))
        model.head.dropout_rate = 0.0
        return SpecTrainer(
            cfg, model, {'neutral': assets}, jreg,
            lambda epoch: CamDataset(os.path.join(train, 'annots.npz'),
                                     os.path.join(train, 'imgs'), 'spec-syn',
                                     is_train=True, img_res=64, seed=epoch,
                                     aug=NO_AUG),
            dict)

    t1 = make()
    t1._fit(1, _StopAtStep(t1, 1, par.process_index()))
    out['preempted_at'] = t1.state.step
    t2 = make()
    t2.resume()
    out['resumed_at'] = t2.state.step
    t2._fit(1, _StopAtStep(t2, 10 ** 6, 0))
    out['trainer_steps'] = t2.state.step
    out['trainer_logdir'] = cfg.LOGDIR
    out['trainer_state'] = {k: v.clone()
                            for k, v in t2.model.state_dict().items()}


def main():
    rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    # no TensorBoard writer (its import takes seconds; not checked here)
    sys.modules['torch.utils.tensorboard'] = None
    from spec_tpu_torch import parallel as par

    par.initialize_multihost(f'127.0.0.1:{port}', world, rank,
                             device='cpu')
    assert (par.process_index(), par.process_count()) == (rank, world)
    out = {'backend': par.backend(),
           'any_rank1': par.all_processes_any(rank == 1),
           'any_none': par.all_processes_any(False),
           'string': par.broadcast_string(f'logs/rank{rank}')}
    for part in (spec_steps, camcalib_step, trainer_epoch):
        t0 = time.perf_counter()
        part(par, out, d)
        print(f'[rank {rank}] {part.__name__}: '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    torch.save(out, os.path.join(d, f'rank{rank}.pt'))
    par.barrier()
    print(f'[rank {rank}] DONE', flush=True)


if __name__ == '__main__':
    main()
