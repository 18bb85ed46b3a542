"""Asset path registry (the subset of ``spec_tpu/utils/paths.py`` that
serving reads). Everything is rooted at ``SPEC_DATA_ROOT`` (default
``./data``), so the reference's ``prepare_data.sh`` layout works as is."""

from __future__ import annotations

import os
from os.path import join


def data_root() -> str:
    return os.environ.get('SPEC_DATA_ROOT', 'data')


def smpl_model_dir() -> str:
    return join(data_root(), 'body_models', 'smpl')


def j_regressor_h36m_path() -> str:
    return join(data_root(), 'J_regressor_h36m.npy')


def j_regressor_extra_path() -> str:
    return join(data_root(), 'J_regressor_extra.npy')


def camcalib_checkpoint_path() -> str:
    return join(data_root(), 'camcalib', 'checkpoints',
                'camcalib_sa_biased_l2.ckpt')


def spec_checkpoint_path() -> str:
    return join(data_root(), 'spec', 'checkpoints', 'spec_checkpoint.ckpt')
