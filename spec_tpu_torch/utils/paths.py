"""Asset path registry (the subset of ``spec_tpu/utils/paths.py`` that
the port reads). Everything is rooted at ``SPEC_DATA_ROOT`` (default
``./data``), so the reference's ``prepare_data.sh`` layout works as is."""

from __future__ import annotations

import os
from os.path import join


def data_root() -> str:
    return os.environ.get('SPEC_DATA_ROOT', 'data')


def smpl_model_dir() -> str:
    return join(data_root(), 'body_models', 'smpl')


def smpl_mean_params_path() -> str:
    return join(data_root(), 'smpl_mean_params.npz')


def j_regressor_h36m_path() -> str:
    return join(data_root(), 'J_regressor_h36m.npy')


def j_regressor_extra_path() -> str:
    return join(data_root(), 'J_regressor_extra.npy')


def camcalib_checkpoint_path() -> str:
    return join(data_root(), 'camcalib', 'checkpoints',
                'camcalib_sa_biased_l2.ckpt')


def spec_checkpoint_path() -> str:
    return join(data_root(), 'spec', 'checkpoints', 'spec_checkpoint.ckpt')


def dataset_folders() -> dict:
    d = data_root()
    return {
        'spec-mtp': join(d, 'dataset_folders', 'spec-mtp'),
        'spec-syn': join(d, 'dataset_folders', 'spec-syn'),
        '3dpw-test-cam': join(d, 'dataset_folders', '3dpw'),
        '3dpw': join(d, 'dataset_folders', '3dpw'),
        'pano360': join(d, 'dataset_folders', 'pano360'),
    }


def dataset_files() -> dict:
    d = join(data_root(), 'dataset_extras')
    return {
        'spec-mtp': join(d, 'spec-mtp_camcalib.npz'),
        'spec-syn': join(d, 'spec-syn_camcalib.npz'),
        '3dpw-test-cam': join(d, '3dpw_test_cam_camcalib.npz'),
    }
