"""CamCalib training CLI (port of ``spec_tpu/cli/camcalib_train.py``).

config -> the pano datasets (``data/pano_dataset.py``,
``data/pano_agora_dataset.py``) -> shape-bucketed batches (one train
step graph per bucket, the counterpart of the JAX step's one compile per
bucket) -> validation MAE in degrees after each epoch (decoded angles,
one graph per bucket under ``torch.inference_mode``) -> checkpoints
under ``<logdir>/checkpoints``.

Usage:
  python -m spec_tpu_torch.cli.camcalib_train \\
      --cfg configs/camcalib/config_sa_bias_l2.yaml

Runs on the card (``--device cuda``, the default) and exits non-zero
without one unless ``--device cpu`` is given. TRAINING.PRETRAINED
starts from a released torch file or a checkpoint directory of this
trainer (weights only); ``--resume`` continues the latest checkpoint,
skipping the batches it already trained (the bucketed order is seeded
by the epoch). SIGTERM saves the in-flight state. The error CDFs and
the horizon images of the first validation batch are optional
artifacts: they are skipped, with a line saying why, when matplotlib,
cv2 or PIL is missing.

Multi-process training (``--coordinator_address``, ``--num_processes``,
``--process_id``, ``--dist_backend``, or a launcher's environment; one
process per GPU, as ``spec_train``): each rank loads its contiguous
slice of every bucketed global batch, the ranks agree on a SIGTERM
before the save, every rank validates on the whole val set on its own
and rank 0 alone writes checkpoints and images.

:func:`train` is the loop without the command line: it takes any
dataset with ``__getitem__``, ``__len__`` and ``shape_buckets()``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from spec_tpu_torch.cli._compat import add_cluster_flags
from spec_tpu_torch.cli._device import (
    add_device_flag,
    add_process_flags,
    join_processes,
    resolve_device,
)

PROG = 'spec_tpu_torch.cli.camcalib_train'


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='CamCalib train (PyTorch)')
    parser.add_argument('--cfg', type=str, default=None)
    parser.add_argument('--opts', nargs='*', default=[])
    parser.add_argument('--cfg_id', type=int, default=0)
    parser.add_argument('--log_root', type=str, default='logs')
    parser.add_argument('--resume', action='store_true',
                        help='resume from the latest checkpoint')
    parser.add_argument('--fdr', action='store_true',
                        help='fast dev run: two steps, one val batch')
    add_process_flags(parser)
    add_cluster_flags(parser, num_gpus=True)
    add_device_flag(parser)
    return parser


def build_datasets(cfg, loss_type: str) -> tuple:
    """(train, val) datasets of DATASET.TRAIN_DS under the registry's
    ``pano360`` folder."""
    from spec_tpu_torch.data.pano_agora_dataset import PanoAgoraDataset
    from spec_tpu_torch.data.pano_dataset import CameraRegressorDataset
    from spec_tpu_torch.utils import paths

    folder = paths.dataset_folders().get('pano360', 'data/pano360')
    decode_cache = int(cfg.DATASET.get('DECODE_CACHE', 0) or 0)
    num_images = int(cfg.DATASET.get('NUM_IMAGES', -1) or -1)

    def build(is_train):
        # DEVICE_JITTER applies to the train loader only: validation
        # stays host-normalized fp32.
        jitter = is_train and cfg.DATASET.get('DEVICE_JITTER', False)
        if cfg.DATASET.TRAIN_DS == 'pano_agora':
            return PanoAgoraDataset(
                folder, is_train=is_train, min_size=cfg.DATASET.MIN_RES,
                max_size=cfg.DATASET.MAX_RES, loss_type=loss_type,
                decode_cache=decode_cache, num_images=num_images,
                device_jitter=jitter)
        return CameraRegressorDataset(
            folder, dataset=cfg.DATASET.TRAIN_DS, is_train=is_train,
            min_size=cfg.DATASET.MIN_RES, max_size=cfg.DATASET.MAX_RES,
            loss_type=loss_type,
            fast_decode=is_train and cfg.DATASET.get('FAST_DECODE', False),
            decode_cache=decode_cache, num_images=num_images,
            device_jitter=jitter)

    return build(True), build(False)


def build_model(cfg, device, resume: bool = False):
    """The CameraRegressorNetwork of MODEL on ``device`` in train mode: a
    random init from seed 0, or TRAINING.PRETRAINED's weights (a torch
    file, tensors of another shape keeping the init; or a checkpoint
    directory of this trainer) unless resuming."""
    import torch

    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.utils.checkpoints import (
        load_camcalib_variables,
        load_checkpoint_variables,
    )

    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[
        cfg.MODEL.get('DTYPE', 'float32')]
    model = CameraRegressorNetwork(
        backbone=cfg.MODEL.BACKBONE, num_fc_layers=cfg.MODEL.NUM_FC_LAYERS,
        num_fc_channels=cfg.MODEL.NUM_FC_CHANNELS, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    pretrained = cfg.TRAINING.get('PRETRAINED') or None
    if pretrained and not resume:
        if os.path.isdir(pretrained):
            sd = load_checkpoint_variables(pretrained)
        else:
            sd = load_camcalib_variables(
                pretrained, backbone=cfg.MODEL.BACKBONE,
                num_fc_layers=cfg.MODEL.NUM_FC_LAYERS,
                template=model.state_dict())
        model.load_state_dict(sd)
        print(f'[camcalib-train] fine-tune init from {pretrained}')
    return model.to(device).train()


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = join_processes(args, resolve_device(args.device, PROG))

    from spec_tpu_torch.utils.config import (
        camcalib_default_config,
        resolve_camcalib_loss,
        run_grid_search_experiments,
    )

    cfg = run_grid_search_experiments(
        args.cfg, camcalib_default_config(), script='camcalib_train.py',
        cfg_id=args.cfg_id, opts=args.opts, log_root=args.log_root)
    from spec_tpu_torch import parallel as par
    if par.process_count() > 1:
        cfg.LOGDIR = par.broadcast_string(cfg.LOGDIR)
        os.makedirs(cfg.LOGDIR, exist_ok=True)
    train_ds, val_ds = build_datasets(cfg, resolve_camcalib_loss(cfg))
    return train(cfg, train_ds, val_ds, device, resume=args.resume,
                 fdr=args.fdr)


def steps_per_epoch(dataset, batch_size: int) -> int:
    """Bucketed batches per epoch: each bucket gives
    ceil(len(bucket) / B) batches, the last padded."""
    return max(sum((len(idxs) + batch_size - 1) // batch_size
                   for idxs in dataset.shape_buckets().values()), 1)


def train(cfg, train_ds, val_ds, device, resume: bool = False,
          fdr: bool = False):
    """Train :func:`build_model`'s model on ``train_ds``, validating on
    ``val_ds``, with checkpoints under ``cfg.LOGDIR``. Returns the train
    state. ``fdr``: one epoch of two steps and one val batch."""
    from spec_tpu_torch.train import (
        create_train_state,
        make_camcalib_train_step,
        make_optimizer,
    )
    from spec_tpu_torch.utils.checkpoints import (
        find_resume_checkpoint_dir,
        latest_step,
        restore_checkpoint,
    )
    from spec_tpu_torch.utils.config import resolve_camcalib_loss
    from spec_tpu_torch.utils.preemption import GracefulShutdown

    loss_type = resolve_camcalib_loss(cfg)
    model = build_model(cfg, device, resume=resume)
    tx = make_optimizer(
        cfg.OPTIMIZER,
        grad_accum_steps=int(cfg.TRAINING.get('GRAD_ACCUM_STEPS', 1) or 1))
    state = create_train_state(model, tx)
    step = make_camcalib_train_step(
        model, tx, loss_type=loss_type,
        vfov_loss_weight=cfg.MODEL.get('LOSS_VFOV_WEIGHT', 1.0),
        pitch_loss_weight=cfg.MODEL.get('LOSS_PITCH_WEIGHT', 1.0),
        roll_loss_weight=cfg.MODEL.get('LOSS_ROLL_WEIGHT', 1.0))

    ckpt_dir = os.path.join(cfg.LOGDIR, 'checkpoints')
    if resume:
        if latest_step(ckpt_dir) is not None:
            src, pinned = ckpt_dir, None
        else:
            found = find_resume_checkpoint_dir(
                cfg.LOGDIR, explicit=cfg.TRAINING.get('RESUME') or None)
            src, pinned = found if found else (None, None)
        if src is None:
            print('[camcalib-train] WARNING: --resume requested but no '
                  'checkpoint found — starting from scratch')
        else:
            state = restore_checkpoint(src, state, step=pinned)
            print(f'[camcalib-train] resumed from {src} at step '
                  f'{state.step}')
    max_epochs = 1 if fdr else cfg.TRAINING.MAX_EPOCHS
    # The true step count continues; epochs already run are skipped, and
    # the leftover steps map one to one onto the first index chunks of
    # the next epoch (its bucketed order is seeded by the epoch).
    global_step = int(state.step)
    per_epoch = steps_per_epoch(train_ds, cfg.DATASET.BATCH_SIZE)
    start_epoch = min(global_step // per_epoch, max_epochs)
    skip_first = global_step - start_epoch * per_epoch
    if start_epoch or skip_first:
        print(f'[camcalib-train] skipping {start_epoch} completed '
              f'epoch(s) + {skip_first} batch(es) '
              f'({per_epoch} steps/epoch)')
    with GracefulShutdown() as stop:
        return _train_epochs(cfg, stop, state, step, train_ds, val_ds,
                             loss_type, ckpt_dir, max_epochs, start_epoch,
                             global_step, skip_first, fdr=fdr)


_TRAIN_KEYS = ('img', 'vfov', 'pitch', 'roll', 'jitter_A', 'jitter_b',
               'true_shape')


def _train_epochs(cfg, stop, state, step, train_ds, val_ds, loss_type,
                  ckpt_dir, max_epochs, start_epoch, global_step,
                  skip_first=0, fdr=False):
    import torch

    from spec_tpu_torch import parallel as par
    from spec_tpu_torch.core import bins as B
    from spec_tpu_torch.utils.checkpoints import save_checkpoint
    from spec_tpu_torch.utils.graphs import StageGraph

    model = state.model
    device = next(model.parameters()).device

    def val_infer(img):
        return B.convert_preds_to_angles(*model(img), loss_type=loss_type)

    # one graph per bucket on the card; the model runs in eval mode
    val_graph = StageGraph('camcalib_val', val_infer)
    is_main = par.process_index() == 0
    if par.process_count() > 1:
        print(f'[camcalib-train] rank {par.process_index()} of '
              f'{par.process_count()} ({par.backend()}): the step runs '
              + ('as one graph replay' if step.mode == 'graph'
                 else 'its eager body (gloo collectives cannot be '
                      'captured)'))

    for epoch in range(start_epoch, max_epochs):
        for batch in _bucketed_batches(
                train_ds, cfg.DATASET.BATCH_SIZE, shuffle=True, seed=epoch,
                num_workers=cfg.DATASET.NUM_WORKERS,
                skip=(skip_first if epoch == start_epoch else 0),
                process_id=par.process_index(),
                process_count=par.process_count()):
            # agree before the save's barrier (see parallel.
            # all_processes_any)
            if par.all_processes_any(stop.requested):
                save_checkpoint(ckpt_dir, state, global_step)
                if is_main:
                    print(f'[camcalib-train] preempted at step '
                          f'{global_step}; checkpoint saved to {ckpt_dir}')
                return state
            # DEVICE_JITTER batches: u8 frames, per-image affines and the
            # true shapes (the pad mask is rebuilt on the device).
            dev = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
                device, non_blocking=True)
                for k in _TRAIN_KEYS if k in batch}
            state, metrics = step(state, dev)
            global_step += 1
            log_every = int(cfg.TRAINING.get('LOG_SAVE_INTERVAL', 50))
            if global_step % max(log_every, 1) == 0 or fdr:
                loss = float(metrics['loss'])
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        'non-finite loss: '
                        f'{ {k: float(v) for k, v in metrics.items()} }')
                print(f'[camcalib-train] epoch {epoch} step {global_step} '
                      f'loss {loss:.4f}')
            if fdr and global_step >= 2:
                break

        # validation: decoded-angle MAE in degrees every
        # CHECK_VAL_EVERY_N_EPOCH epochs
        val_every = max(int(cfg.TRAINING.get('CHECK_VAL_EVERY_N_EPOCH', 1)),
                        1)
        if not fdr and (epoch + 1) % val_every != 0:
            save_checkpoint(ckpt_dir, state, global_step)
            continue
        # every rank validates the whole val set on its own (the weights
        # are replicated; no collectives) and gets the same MAE
        errs = {'vfov': [], 'pitch': [], 'roll': []}
        first_val_batch = first_val_pred = None
        model.eval()
        try:
            with torch.inference_mode():
                for batch in _bucketed_batches(
                        val_ds, cfg.DATASET.BATCH_SIZE, shuffle=False,
                        seed=0, num_workers=cfg.DATASET.NUM_WORKERS):
                    img = torch.from_numpy(batch['img']).to(device)
                    pred = [p.cpu().numpy() for p in val_graph(img)]
                    if first_val_batch is None:
                        first_val_batch, first_val_pred = batch, pred
                    # the tail chunk repeats its last sample: count each
                    # real sample once
                    n_valid = int(batch.get('valid_count', len(img)))
                    for k, p in zip(('vfov', 'pitch', 'roll'), pred):
                        gt = batch[f'{k}_angle'][:n_valid]
                        errs[k] += np.degrees(
                            np.abs(p[:n_valid] - gt)).tolist()
                    if fdr:
                        break
        finally:
            model.train()
        mae = {k: float(np.mean(v)) for k, v in errs.items() if v}
        print(f'[camcalib-val] epoch {epoch} MAE(deg): {mae}')
        if is_main:
            _save_val_images(errs, first_val_batch, first_val_pred,
                             os.path.join(cfg.LOGDIR, 'val_images'), epoch)
        save_checkpoint(ckpt_dir, state, global_step)
        if fdr:
            break
    return state


def _save_val_images(errs, first_val_batch, first_val_pred, vis_dir,
                     epoch) -> None:
    """The error CDFs and the first val batch's horizons, each skipped
    with a line when its libraries are missing."""
    try:
        from spec_tpu_torch.utils.vis import plot_error_cdf
        os.makedirs(vis_dir, exist_ok=True)
        for k, v in errs.items():
            if v:
                plot_error_cdf(
                    v, os.path.join(vis_dir, f'cdf_{k}_epoch{epoch}.png'),
                    label=k)
    except Exception as e:
        print(f'[camcalib-val] cdf plots skipped: {e}')
    if first_val_batch is not None:
        try:
            _save_horizon_dumps(first_val_batch, first_val_pred, vis_dir,
                                epoch)
        except Exception as e:
            print(f'[camcalib-val] horizon dumps skipped: {e}')


def _save_horizon_dumps(batch, pred_angles, vis_dir, epoch, max_n=4):
    """GT (green) and predicted (yellow) horizons on the first images of
    a validation batch, un-normalized and cropped to their true size."""
    from PIL import Image

    from spec_tpu_torch.core import constants as C
    from spec_tpu_torch.utils.vis import gt_vs_pred_horizon

    os.makedirs(vis_dir, exist_ok=True)
    vfov, pitch, roll = pred_angles
    for i in range(min(max_n, len(batch['img']))):
        img = np.asarray(batch['img'][i], np.float32)
        img = (img * C.IMG_NORM_STD + C.IMG_NORM_MEAN) * 255.0
        if 'pad_mask' in batch:
            m = np.asarray(batch['pad_mask'][i])
            h = max(int(m.any(axis=1).sum()), 1)
            w = max(int(m.any(axis=0).sum()), 1)
            img = img[:h, :w]
        img = np.clip(img, 0, 255).astype(np.uint8)
        out = gt_vs_pred_horizon(
            img,
            (float(batch['vfov_angle'][i]), float(batch['pitch_angle'][i]),
             float(batch['roll_angle'][i])),
            (float(vfov[i]), float(pitch[i]), float(roll[i])))
        Image.fromarray(out).save(
            os.path.join(vis_dir, f'horizon_e{epoch:03d}_{i}.png'))


def _bucketed_batches(dataset, batch_size, shuffle, seed, num_workers,
                      skip=0, process_id=0, process_count=1):
    """Batches within padded-shape buckets, so each bucket has one input
    signature. The bucket order and each bucket's indices are shuffled
    by ``RandomState(seed)``; ``skip`` drops the first chunks at the
    index level (a mid-epoch resume reads none of them). A tail chunk
    repeats its last item up to ``batch_size``; ``valid_count`` says how
    many are real. ``process_id`` / ``process_count``: each process
    fetches its contiguous slice of every global chunk
    (``data/loader.shard_index_chunk``), and ``valid_count`` is the
    slice's real rows."""
    import concurrent.futures as cf

    from spec_tpu_torch.data.loader import shard_index_chunk
    from spec_tpu_torch.data.pano_dataset import pad_collate

    buckets = dataset.shape_buckets()
    rng = np.random.RandomState(seed)
    order = list(buckets.items())
    if shuffle:
        rng.shuffle(order)
    with cf.ThreadPoolExecutor(max(1, num_workers)) as pool:
        for bucket_hw, idxs in order:
            idxs = list(idxs)
            if shuffle:
                rng.shuffle(idxs)
            for s in range(0, len(idxs), batch_size):
                if skip > 0:
                    skip -= 1
                    continue
                local, n_valid = shard_index_chunk(
                    idxs[s:s + batch_size], batch_size, process_id,
                    process_count)
                # fetch the real entries (one when the slice has none);
                # pad rows repeat the last item
                real = local[:n_valid] if n_valid else local[:1]
                items = list(pool.map(dataset.__getitem__, real))
                while len(items) < len(local):
                    items.append(items[-1])
                batch = pad_collate(items, fixed_hw=bucket_hw)
                batch['valid_count'] = n_valid
                yield batch


if __name__ == '__main__':
    main()
