"""``export_model``: package the two-stage predictor as a ``.specx``
artifact (``torch.export`` programs + weights + config; see
:mod:`spec_tpu_torch.export`). Port of ``spec_tpu/cli/export_model.py``.

Typical flow::

    python -m spec_tpu_torch.cli.export_model --spec_ckpt ckpt.pt \\
        --camcalib_ckpt cam.ckpt --output spec.specx
    python -m spec_tpu_torch.cli.serve --exported spec.specx

The programs are traced on ``--device`` (default ``cuda``; ``cpu`` must
be asked for); an artifact exported on either device runs on every
device in ``--platforms`` (default ``cpu,cuda``), with K1 on a card.
Missing checkpoints give a random init from fixed seeds, with a warning.
"""

from __future__ import annotations

import argparse
import os

from spec_tpu_torch.cli._device import add_device_flag, resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description='Export the SPEC two-stage pipeline to a .specx '
                    'artifact (torch.export)')
    parser.add_argument('--output', type=str, required=True,
                        help='artifact path (convention: *.specx)')
    parser.add_argument('--spec_ckpt', type=str, default='')
    parser.add_argument('--camcalib_ckpt', type=str, default='')
    parser.add_argument('--cfg', type=str, default='',
                        help='SPEC config yaml shipped with the ckpt '
                             '(HMR.BACKBONE / USE_CAM_FEATS)')
    parser.add_argument('--smpl_model_dir', type=str, default='')
    parser.add_argument('--backbone', type=str, default='resnet50')
    parser.add_argument('--camcalib_backbone', type=str, default='resnet50')
    parser.add_argument('--loss_type', type=str,
                        default='softargmax_biased_l2',
                        help='CamCalib bin decode flavor')
    parser.add_argument('--min_size', type=int, default=600,
                        help='stage-1 resize target recorded in the '
                             'artifact (reference Resize(600))')
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--platforms', type=str, default='cpu,cuda',
                        help='comma list of the device types the artifact '
                             'may be loaded on (cpu, cuda)')
    add_device_flag(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device, 'spec_tpu_torch.cli.export_model')

    from spec_tpu_torch.export import export_predictor
    from spec_tpu_torch.serving import SpecPredictor

    pred = SpecPredictor(
        spec_ckpt=args.spec_ckpt, camcalib_ckpt=args.camcalib_ckpt,
        cfg_file=args.cfg, smpl_model_dir=args.smpl_model_dir,
        backbone=args.backbone, camcalib_backbone=args.camcalib_backbone,
        loss_type=args.loss_type, min_size=args.min_size,
        batch_size=args.batch_size, device=device)
    platforms = tuple(p.strip() for p in args.platforms.split(',')
                      if p.strip())
    out = export_predictor(pred, args.output, platforms=platforms)
    print(f'[export] wrote {out} ({os.path.getsize(out) / 2**20:.1f} MiB, '
          f'platforms={list(platforms)}, traced on {device})')


if __name__ == '__main__':
    main()
