"""SPEC training CLI (port of ``spec_tpu/cli/spec_train.py``).

config -> datasets (the mixed and staged schedules) -> ``SpecTrainer``
(train steps on the device, one CUDA graph replay each on a card) ->
checkpoints under ``<logdir>/checkpoints`` (``spec_eval --ckpt`` loads
them).

Usage:
  python -m spec_tpu_torch.cli.spec_train --cfg configs/spec.yaml \\
      --opts TRAINING.MAX_EPOCHS 5

Runs on the card (``--device cuda``, the default) and exits non-zero
without one unless ``--device cpu`` is given; on the card the SMPL
forwards of the step run the fused LBS kernel (K1) and its backward.
``--ckpt`` (or TRAINING.PRETRAINED_LIT) is a reference torch checkpoint
or a trainer checkpoint directory; without one the model starts from a
seeded random init with a warning (the reference always starts from
pretrained weights). Not ported yet: multi-host training
(``--coordinator_address``, ``--num_processes``, ``--process_id``;
ROADMAP.md §1 item 12).
"""

from __future__ import annotations

import argparse
import os

from spec_tpu_torch.cli._compat import add_cluster_flags
from spec_tpu_torch.cli._device import add_device_flag, resolve_device

PROG = 'spec_tpu_torch.cli.spec_train'


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='SPEC train (PyTorch)')
    parser.add_argument('--cfg', type=str, default=None)
    parser.add_argument('--opts', nargs='*', default=[])
    parser.add_argument('--cfg_id', type=int, default=0)
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--resume_wo_optimizer', action='store_true',
                        help='resume params/batch_stats only, fresh '
                             'optimizer (reference '
                             'scripts/spec_train.py:147-149)')
    parser.add_argument('--ckpt', type=str, default='',
                        help='pretrained torch ckpt to start from')
    parser.add_argument('--log_root', type=str, default='logs')
    parser.add_argument('--fdr', action='store_true',
                        help='fast dev run: 1 epoch')
    parser.add_argument('--coordinator_address', type=str, default='',
                        help='multi-host training: not ported yet '
                             '(ROADMAP.md §1 item 12)')
    parser.add_argument('--num_processes', type=int, default=None,
                        help='multi-host: not ported yet (item 12)')
    parser.add_argument('--process_id', type=int, default=None,
                        help='multi-host: not ported yet (item 12)')
    add_cluster_flags(parser)
    add_device_flag(parser)
    return parser


def _augmentation(cfg):
    from spec_tpu_torch.data.cam_dataset import AugmentationConfig

    return AugmentationConfig(
        flip_prob=cfg.DATASET.FLIP_PROB,
        noise_factor=cfg.DATASET.NOISE_FACTOR,
        rot_factor=cfg.DATASET.ROT_FACTOR,
        scale_factor=cfg.DATASET.SCALE_FACTOR,
        crop_prob=cfg.DATASET.CROP_PROB,
        crop_factor=cfg.DATASET.CROP_FACTOR,
        use_occlusion=cfg.DATASET.USE_SYNTHETIC_OCCLUSION,
        use_3d_conf=cfg.DATASET.USE_3D_CONF,
    )


def build_model(cfg, ckpt: str, device):
    """The camera-aware HMR of the config on ``device`` in train mode
    (TRAINING.REMAT checkpoints its blocks): ``ckpt``'s weights, or a
    random init from seed 0 with a warning."""
    import torch

    from spec_tpu_torch.serving import build_hmr

    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[
        cfg.HMR.get('DTYPE', 'float32')]
    if ckpt and os.path.exists(str(ckpt)):
        print(f'[train] loading pretrained weights from {ckpt}')
    else:
        print('[train] no pretrained ckpt; random init (the reference '
              'always starts from SPIN/PARE weights)')
    # The reference's trainer builds its HMR at the default crop_res
    # (224), whatever DATASET.IMG_RES is.
    model = build_hmr(str(ckpt or ''), device, backbone=cfg.HMR.BACKBONE,
                      use_cam_feats=cfg.HMR.USE_CAM_FEATS, dtype=dtype,
                      seed=0, tag='train',
                      remat=bool(cfg.TRAINING.get('REMAT', False)))
    return model.train()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.coordinator_address or args.num_processes or \
            args.process_id is not None:
        raise NotImplementedError(
            'multi-host training (--coordinator_address, --num_processes, '
            '--process_id) is not ported yet (ROADMAP.md §1 item 12)')
    device = resolve_device(args.device, PROG)

    from spec_tpu_torch.cli.spec_eval import (
        h36m_regressor,
        load_assets_by_gender,
    )
    from spec_tpu_torch.data.cam_dataset import CamDataset
    from spec_tpu_torch.data.loader import DataLoader
    from spec_tpu_torch.data.mixed_dataset import (
        MixedCamDataset,
        parse_datasets_ratios,
    )
    from spec_tpu_torch.train.trainer import SpecTrainer, parse_schedule
    from spec_tpu_torch.utils import paths
    from spec_tpu_torch.utils.config import (
        run_grid_search_experiments,
        spec_default_config,
        split_ds_names,
    )

    cfg = run_grid_search_experiments(
        args.cfg, spec_default_config(), script='spec_train.py',
        cfg_id=args.cfg_id, opts=args.opts, log_root=args.log_root)

    # The train and eval steps move the assets to the device and attach
    # the fused LBS kernel's operands (bench.py's train setup attaches
    # them off the CPU).
    assets_by_gender = load_assets_by_gender()
    jreg = h36m_regressor(assets_by_gender['neutral'])
    aug = _augmentation(cfg)

    def build_cam_dataset(name, is_train):
        annot = paths.dataset_files().get(name)
        folder = paths.dataset_folders().get(name)
        assert annot and os.path.exists(annot), f'missing annots for {name}'
        return CamDataset(
            annot, folder, dataset=name, is_train=is_train,
            img_res=cfg.DATASET.IMG_RES, aug=aug,
            ignore_3d=cfg.DATASET.get('IGNORE_3D', False),
            baseline_cam_rot=cfg.DATASET.BASELINE_CAM_ROT,
            baseline_cam_f=cfg.DATASET.BASELINE_CAM_F,
            baseline_cam_c=cfg.DATASET.BASELINE_CAM_C,
            fast_decode=is_train and cfg.DATASET.get('FAST_DECODE', False),
            decode_cache=cfg.DATASET.get('DECODE_CACHE', 0),
            native_decode=cfg.DATASET.get('NATIVE_DECODE', True),
            region_cache_dir=cfg.DATASET.get('REGION_CACHE_DIR', ''),
            region_cache_format=cfg.DATASET.get('REGION_CACHE_FORMAT',
                                                'jpeg'))

    stage_sched = parse_schedule(cfg.DATASET.STAGE_DATASETS)
    tf_sched = parse_schedule(cfg.DATASET.get('TEACHER_FORCE_SCHEDULE', ''))

    def make_train_dataset(epoch):
        if epoch in tf_sched:
            # The reference's dataset never reads it; only the hparam
            # changes (kept for parity).
            cfg.DATASET.TEACHER_FORCE = float(tf_sched[epoch])
            print(f'[train] teacher force -> {cfg.DATASET.TEACHER_FORCE}')
        ratios_spec = cfg.DATASET.DATASETS_AND_RATIOS
        if isinstance(ratios_spec, list):
            ratios_spec = '_'.join(str(x) for x in ratios_spec)
        if cfg.DATASET.TRAIN_DS == 'stage' and epoch in stage_sched:
            ratios_spec = stage_sched[epoch]
        if cfg.DATASET.TRAIN_DS in ('all', 'stage'):
            names, ratios = parse_datasets_ratios(ratios_spec)
            members = [build_cam_dataset(n, True) for n in names]
            if len(members) == 1:
                return members[0]
            return MixedCamDataset(members, ratios, seed=epoch)
        return build_cam_dataset(cfg.DATASET.TRAIN_DS, True)

    def make_val_loaders():
        out = {}
        for n in split_ds_names(cfg.DATASET.VAL_DS):
            annot = paths.dataset_files().get(n)
            if not annot or not os.path.exists(annot):
                continue
            ds = build_cam_dataset(n, False)
            out[n] = DataLoader(
                ds, batch_size=cfg.DATASET.BATCH_SIZE,
                num_workers=cfg.DATASET.NUM_WORKERS,
                group_keys=(ds.imgname
                            if cfg.DATASET.get('GROUP_BY_FRAME', False)
                            else None))
        return out

    ckpt = args.ckpt or cfg.TRAINING.PRETRAINED_LIT \
        or paths.spec_checkpoint_path()
    model = build_model(cfg, ckpt, device)
    trainer = SpecTrainer(cfg, model, assets_by_gender, jreg,
                          make_train_dataset, make_val_loaders)
    if args.resume or args.resume_wo_optimizer:
        trainer.resume(wo_optimizer=args.resume_wo_optimizer)
    trainer.fit(max_epochs=1 if args.fdr else None)
    return trainer


if __name__ == '__main__':
    main()
