"""CamCalib result IO (port of ``spec_tpu/utils/cam_params.py``).

The stage-1 -> stage-2 interface of the demos: a pickle per image with
{vfov, f_pix, pitch, roll}, read back as the camera rotation
``R = Rx(pitch) @ Rz(roll)`` and intrinsics ``K = [[f, 0, w/2], [0, f,
h/2], [0, 0, 1]]``. joblib is imported where a pickle is read.
"""

from __future__ import annotations

import os

import numpy as np

from spec_tpu_torch.core.geometry import euler_pitch_roll_np


def read_cam_params(pkl_path: str, img_w: float, img_h: float):
    """-> (cam_rotmat (3,3), cam_int (3,3), vfov, pitch, roll, f_pix)."""
    import joblib

    data = joblib.load(pkl_path)
    pitch = float(data['pitch'])
    roll = float(data['roll'])
    vfov = float(data['vfov'])
    f_pix = float(data['f_pix'])
    K = np.array([[f_pix, 0, img_w / 2.0],
                  [0, f_pix, img_h / 2.0],
                  [0, 0, 1]], np.float32)
    return euler_pitch_roll_np(pitch, roll), K, vfov, pitch, roll, f_pix


def cam_params_path(out_folder: str, imgname: str) -> str:
    return os.path.join(out_folder, 'camcalib',
                        os.path.basename(imgname) + '.pkl')
