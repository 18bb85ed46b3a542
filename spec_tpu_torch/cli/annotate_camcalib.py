"""Write CamCalib prediction columns into a SPEC eval/train npz (port of
``spec_tpu/cli/annotate_camcalib.py``).

Runs the port's CamCalib stage (``camcalib_demo.run_camcalib_on_folder``)
over every unique image the npz names and writes
``camcalib_{vfov,pitch,roll,f_pix}`` beside its columns, so a new
dataset can be evaluated with ``TESTING.USE_GT_CAM False``:

    python -m spec_tpu_torch.cli.annotate_camcalib --npz 3dpw_test.npz \\
        --img_dir dataset_folders/3dpw --ckpt camcalib_sa_biased_l2.ckpt

``f_pix = H/2 / tan(vfov/2)`` on the original image height, as the demo
decodes it. Runs on the card (``--device cuda``, the default) and exits
non-zero without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from spec_tpu_torch.cli._device import add_device_flag, resolve_device


def annotate_npz(npz_path: str, img_dir: str, out_path: str,
                 ckpt: str = '', backbone: str = 'resnet50',
                 loss_type: str = 'softargmax_biased_l2',
                 min_size: int = 600, batch_size: int = 16,
                 device='cuda') -> dict:
    """Returns the augmented npz dict (also written to ``out_path``)."""
    from spec_tpu_torch.cli.camcalib_demo import run_camcalib_on_folder

    data = dict(np.load(npz_path, allow_pickle=True))
    if 'imgname' not in data:
        raise SystemExit(f'{npz_path} has no imgname column')
    imgnames = [str(x) for x in data['imgname']]
    unique = sorted(set(imgnames))
    image_list = [os.path.join(img_dir, n) for n in unique]
    missing = [p for p in image_list if not os.path.exists(p)]
    if missing:
        raise SystemExit(
            f'{len(missing)} of {len(image_list)} images not found under '
            f'{img_dir} (first: {missing[0]})')

    with tempfile.TemporaryDirectory() as tmp:
        results = run_camcalib_on_folder(
            None, tmp, ckpt=ckpt, backbone=backbone, loss_type=loss_type,
            batch_size=batch_size, save_images=False, min_size=min_size,
            image_list=image_list, device=device)

    by_name = {n: results[p] for n, p in zip(unique, image_list)}
    for col, key in (('camcalib_vfov', 'vfov'), ('camcalib_pitch', 'pitch'),
                     ('camcalib_roll', 'roll'), ('camcalib_f_pix', 'f_pix')):
        data[col] = np.asarray([by_name[n][key] for n in imgnames],
                               np.float32)
    np.savez(out_path, **data)
    print(f'[annotate] wrote {out_path} '
          f'({len(imgnames)} rows, {len(unique)} unique images)')
    return data


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Add camcalib_* prediction columns to a SPEC npz '
                    '(enables TESTING.USE_GT_CAM False on new datasets)')
    parser.add_argument('--npz', required=True,
                        help='input annotation npz (imgname column)')
    parser.add_argument('--img_dir', required=True,
                        help='root the imgname column is relative to')
    parser.add_argument('--out', default='',
                        help='output npz (default: <npz>_camcalib.npz)')
    parser.add_argument('--ckpt', type=str, default='',
                        help='CamCalib checkpoint (torch dialects '
                             'auto-detected; default: the registry path)')
    parser.add_argument('--backbone', type=str, default='resnet50')
    parser.add_argument('--loss_type', type=str,
                        default='softargmax_biased_l2')
    parser.add_argument('--min_size', type=int, default=600,
                        help='stage-1 resize bucket (pair reduced buckets '
                             'with a matching fine-tuned checkpoint)')
    parser.add_argument('--batch_size', type=int, default=16)
    add_device_flag(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device,
                            'spec_tpu_torch.cli.annotate_camcalib')
    out = args.out or args.npz.replace('.npz', '') + '_camcalib.npz'
    annotate_npz(args.npz, args.img_dir, out, ckpt=args.ckpt,
                 backbone=args.backbone, loss_type=args.loss_type,
                 min_size=args.min_size, batch_size=args.batch_size,
                 device=device)


if __name__ == '__main__':
    main()
