"""The port's SPEC stage learns end to end: ``tests/test_spec_learning_e2e.py``
ported. Synthetic rendered humans (``datagen/spec_synth.py``: bodies
from the synthetic SMPL assets, rendered by ``csrc/raster.cpp`` into
frames and the npz annotation contract) go through the port's
``spec_train`` CLI, and the port's ``spec_eval`` CLI evaluates its
checkpoint on a held-out rendered split (``spec-mtp``): held-out MPJPE
and PA-MPJPE must fall well below the random init's (the same init
``spec_train`` starts from, through the same CLI).

The reference's recipe: 256 ``spec-syn`` frames (seed 0), 16 ``spec-mtp``
frames (seed 100), ``_OPTS`` below, 10 epochs of B = 8 (320 steps,
at least 300), Adam 3e-4; MPJPE under init / 1.2 and PA-MPJPE under
init / 1.3. ``chip_smoke.py`` phase 26 (c) runs that recipe unchanged on
the card (``e2e_run``; this file imports no JAX).

On the CPU the recipe takes over three minutes (0.5-0.7 s a step on one
thread, about half of it in the optimizer's update), so tier-1 runs a
shortened one (``TIER1``: 128 frames, 8 epochs of B = 8, 128 steps, the
same ``_OPTS``, lr and limits). A sound run and a control at lr 0, which
the limits refuse, are recorded in ``CHANGES.md``;
``python tests/test_torch_spec_learning_e2e.py`` prints them, and the
reference's recipe, on the CPU.
"""

import os
import sys

import numpy as np
import pytest
import torch

# No augmentation (the synthetic body is deliberately left/right
# asymmetric, so flips would corrupt supervision), small crops.
BATCH = 8
_OPTS = [
    'DATASET.VAL_DS', 'spec-mtp',
    'DATASET.BATCH_SIZE', str(BATCH),
    'DATASET.NUM_WORKERS', '1',
    'DATASET.IMG_RES', '64',
    'DATASET.FLIP_PROB', '0.0',
    'DATASET.NOISE_FACTOR', '0.0',
    'DATASET.SCALE_FACTOR', '0.0',
    'DATASET.ROT_FACTOR', '0.0',
    'DATASET.CROP_PROB', '0.0',
    'HMR.BACKBONE', 'resnet18',
    'HMR.POSE_LOSS_WEIGHT', '10.0',
    'TESTING.USE_GT_CAM', 'True',
]
# the reference's recipe and limits (init / trained must exceed these)
RECIPE = dict(n_train=256, n_val=16, epochs=10, min_steps=300, lr=3e-4,
              mpjpe=1.2, pampjpe=1.3)
TIER1 = dict(n_train=128, n_val=16, epochs=8, min_steps=128, lr=3e-4,
             mpjpe=1.2, pampjpe=1.3)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: whole models under a parallel test run (see
    tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render_sets(root: str, recipe: dict, device='cpu') -> None:
    """The recipe's train (``spec-syn``, seed 0) and held-out
    (``spec-mtp``, seed 100) sets under ``root``."""
    from spec_tpu_torch.datagen.spec_synth import render_spec_synth_dataset

    render_spec_synth_dataset(root, dataset='spec-syn',
                              n=recipe['n_train'], seed=0, device=device)
    render_spec_synth_dataset(root, dataset='spec-mtp', n=recipe['n_val'],
                              seed=100, device=device)


def eval_mpjpe(log_root: str, device='cpu', ckpt: str = '',
               opts=()) -> dict:
    """The ``spec_eval`` CLI on the held-out set (``opts`` after
    ``_OPTS``): its summary."""
    from spec_tpu_torch.cli import spec_eval

    argv = ['--log_root', log_root, '--device', str(device), '--opts'] + \
        _OPTS + list(opts)
    if ckpt:
        argv = ['--ckpt', ckpt] + argv
    return spec_eval.main(argv)['spec-mtp']


def e2e_run(root: str, log_root: str, recipe: dict, device='cpu',
            lr=None, render: bool = True, opts=()) -> dict:
    """Render the sets (unless ``render`` is False: they are there),
    evaluate the init, train with ``spec_train`` and evaluate its
    checkpoint (``SPEC_DATA_ROOT`` set to ``root`` by the caller;
    ``opts`` after ``_OPTS`` in each CLI, e.g. ``TESTING.SAVE_RESULTS
    False`` where joblib, which writes the results pickle, is missing).
    Returns the two summaries, the trainer's steps and K1's launches in
    ``spec_train`` (``train_k1``; 0 on the CPU, where its plain version
    runs)."""
    from spec_tpu_torch.cli import spec_train
    from spec_tpu_torch.ops import lbs as L

    if render:
        render_sets(root, recipe, device)
    base = eval_mpjpe(os.path.join(log_root, 'eval_init'), device,
                      opts=opts)
    k1 = L.LAUNCHES
    trainer = spec_train.main([
        '--log_root', os.path.join(log_root, 'train'),
        '--device', str(device), '--opts'] + _OPTS + list(opts) + [
        'DATASET.DATASETS_AND_RATIOS', 'spec-syn_1.0',
        'TRAINING.MAX_EPOCHS', str(recipe['epochs']),
        'TRAINING.CHECK_VAL_EVERY_N_EPOCH', str(recipe['epochs']),
        'TRAINING.LOG_SAVE_INTERVAL', '80',
        'OPTIMIZER.LR', str(recipe['lr'] if lr is None else lr),
    ])
    k1 = L.LAUNCHES - k1
    trained = eval_mpjpe(os.path.join(log_root, 'eval_trained'), device,
                         trainer.ckpt_dir, opts)
    return dict(base=base, trained=trained, steps=int(trainer.state.step),
                ckpt_dir=trainer.ckpt_dir, train_k1=k1)


def e2e_misses(r: dict, recipe: dict) -> list:
    """The limits the run misses (none: the held-out errors dropped)."""
    b, t = r['base'], r['trained']
    checks = {
        f'steps {r["steps"]} >= {recipe["min_steps"]}':
            r['steps'] >= recipe['min_steps'],
        'finite metrics': all(np.isfinite(x[k]) for x in (b, t)
                              for k in ('val_mpjpe', 'val_pampjpe')),
        f'MPJPE {t["val_mpjpe"]:.1f} < init {b["val_mpjpe"]:.1f} / '
        f'{recipe["mpjpe"]}': t['val_mpjpe'] < b['val_mpjpe']
        / recipe['mpjpe'],
        f'PA-MPJPE {t["val_pampjpe"]:.1f} < init {b["val_pampjpe"]:.1f} / '
        f'{recipe["pampjpe"]}': t['val_pampjpe'] < b['val_pampjpe']
        / recipe['pampjpe']}
    return [k for k, ok in checks.items() if not ok]


def test_spec_train_then_eval_heldout_mpjpe_drops(tmp_path, monkeypatch):
    from spec_tpu_torch.utils.checkpoints import latest_step

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path / 'data'))
    # no TensorBoard writer (its import takes seconds; not checked here)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    r = e2e_run(str(tmp_path / 'data'), str(tmp_path / 'logs'), TIER1)
    assert latest_step(r['ckpt_dir']) is not None
    misses = e2e_misses(r, TIER1)
    print(f'[e2e] {r["steps"]} steps; MPJPE {r["base"]["val_mpjpe"]:.2f} '
          f'-> {r["trained"]["val_mpjpe"]:.2f}, PA-MPJPE '
          f'{r["base"]["val_pampjpe"]:.2f} -> '
          f'{r["trained"]["val_pampjpe"]:.2f} mm; missed: {misses}')
    assert not misses, misses


if __name__ == '__main__':
    # TIER1 at its lr and at lr 0, then RECIPE, on the CPU
    import tempfile

    torch.set_num_threads(1)
    sys.modules['torch.utils.tensorboard'] = None
    for name, recipe, lr in (('TIER1', TIER1, None), ('TIER1', TIER1, 0.0),
                             ('RECIPE', RECIPE, None)):
        with tempfile.TemporaryDirectory() as d:
            os.environ['SPEC_DATA_ROOT'] = os.path.join(d, 'data')
            r = e2e_run(os.path.join(d, 'data'), os.path.join(d, 'logs'),
                        recipe, lr=lr)
        print(f'{name} lr {recipe["lr"] if lr is None else lr:g}: '
              f'{r["steps"]} steps; MPJPE {r["base"]["val_mpjpe"]:.2f} -> '
              f'{r["trained"]["val_mpjpe"]:.2f}, PA-MPJPE '
              f'{r["base"]["val_pampjpe"]:.2f} -> '
              f'{r["trained"]["val_pampjpe"]:.2f} mm; missed: '
              f'{e2e_misses(r, recipe)}', flush=True)
