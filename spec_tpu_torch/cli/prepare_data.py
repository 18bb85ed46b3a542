"""Data bundle setup/verification (reference ``scripts/prepare_data.sh``;
port of ``spec_tpu/cli/prepare_data.py``).

The reference gdown's a ~1 GB ``spec-github-data.zip`` with checkpoints,
SMPL mean params, joint regressors, and dataset extras. This CLI:

  * ``--verify`` (default): checks the ``SPEC_DATA_ROOT`` layout and
    reports exactly what is present/missing;
  * ``--extract ZIP``: unpacks a locally-downloaded bundle into place;
  * ``--url URL``: downloads then extracts (network permitting).

The SMPL body models are licensed and must be fetched from
https://smpl.is.tue.mpg.de by the user (same policy as the reference).
"""

from __future__ import annotations

import argparse
import os
import zipfile

from spec_tpu_torch.utils import paths

EXPECTED = {
    'SMPL neutral model': lambda: os.path.join(
        paths.smpl_model_dir(), 'SMPL_NEUTRAL.pkl'),
    'SMPL mean params': paths.smpl_mean_params_path,
    'H36M joint regressor': paths.j_regressor_h36m_path,
    'extra joint regressor': paths.j_regressor_extra_path,
    'CamCalib checkpoint': paths.camcalib_checkpoint_path,
    'SPEC checkpoint': paths.spec_checkpoint_path,
    'spec-mtp annots': lambda: paths.dataset_files()['spec-mtp'],
    'spec-syn annots': lambda: paths.dataset_files()['spec-syn'],
    '3dpw-test-cam annots': lambda: paths.dataset_files()['3dpw-test-cam'],
}


def verify() -> dict:
    """Print each expected asset as OK or MISSING under
    ``SPEC_DATA_ROOT``; returns {name: (present, path)}."""
    status = {}
    for name, getter in EXPECTED.items():
        path = getter()
        status[name] = (os.path.exists(path), path)
    width = max(len(k) for k in EXPECTED)
    for name, (ok, path) in status.items():
        mark = 'OK     ' if ok else 'MISSING'
        print(f'  [{mark}] {name:<{width}}  {path}')
    n_ok = sum(ok for ok, _ in status.values())
    print(f'{n_ok}/{len(status)} assets present '
          f'(SPEC_DATA_ROOT={paths.data_root()})')
    return status


def extract(zip_path: str):
    root = paths.data_root()
    os.makedirs(root, exist_ok=True)
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(root)
    print(f'extracted {zip_path} -> {root}')


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--extract', type=str, default='',
                        help='locally downloaded spec data zip to unpack')
    parser.add_argument('--url', type=str, default='',
                        help='bundle URL to download then unpack')
    args = parser.parse_args(argv)

    if args.url:
        import urllib.request
        dst = os.path.join(paths.data_root(), 'spec-data.zip')
        os.makedirs(paths.data_root(), exist_ok=True)
        print(f'downloading {args.url} ...')
        urllib.request.urlretrieve(args.url, dst)
        args.extract = dst
    if args.extract:
        extract(args.extract)
    verify()


if __name__ == '__main__':
    main()
