"""Offline metric CLI (port of ``spec_tpu/cli/compute_error.py``):
recomputes the headline W-MPJPE / MPJPE / PA-MPJPE / W-PVE / PVE table
from a dumped ``evaluation_results_{ds}.pkl`` and the dataset's
annotations, on the device.

Usage:
  python -m spec_tpu_torch.cli.compute_error --results_file \\
      logs/.../evaluation_results_3dpw-test-cam.pkl

Runs on the card (``--device cuda``, the default) and exits non-zero
without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from spec_tpu_torch.cli._device import add_device_flag, resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='SPEC offline headline metrics (PyTorch)')
    parser.add_argument('--results_file', type=str, required=True)
    parser.add_argument('--dataset', type=str, default='',
                        help='override dataset name (default: parsed from '
                             'the filename)')
    add_device_flag(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, 'spec_tpu_torch.cli.compute_error')

    import joblib

    from spec_tpu_torch.cli.spec_eval import _pred_rotmats, h36m_regressor
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.data.cam_dataset import CamDataset
    from spec_tpu_torch.eval.evaluator import compute_error
    from spec_tpu_torch.utils import paths

    ds_name = args.dataset or os.path.basename(args.results_file).replace(
        'evaluation_results_', '').replace('.pkl', '')
    annot = paths.dataset_files()[ds_name]
    ds = CamDataset(annot, paths.dataset_folders().get(ds_name, ''),
                    dataset=ds_name, is_train=False)

    results = joblib.load(args.results_file)
    pred_vertices = np.asarray(results['vertices'], np.float32)
    n = len(pred_vertices)

    assets = S.load_assets_or_test(tag='compute_error')
    jreg = h36m_regressor(assets)

    headline = compute_error(
        ds_name, pred_vertices,
        pred_cam_rotmat=_pred_rotmats(ds)[:n],
        gt_pose=ds.pose[:n], gt_betas=ds.betas[:n],
        assets=assets, j_regressor_h36m=jreg,
        gt_pose_cam=ds.pose_cam[:n] if ds.pose_cam is not None else None,
        gt_cam_rotmat=(np.asarray(ds.cam_rotmat[:n], np.float32)
                       if ds.cam_rotmat is not None else None),
        device=device)
    print(f'***** RESULTS ON {ds_name.upper()} *****')
    print(json.dumps(headline, indent=2, default=float))

    log_path = args.results_file.replace('.pkl', '_analysis.log')
    with open(log_path, 'a') as f:
        f.write(json.dumps({'dataset': ds_name, **headline},
                           default=float) + '\n')
    return headline


if __name__ == '__main__':
    main()
