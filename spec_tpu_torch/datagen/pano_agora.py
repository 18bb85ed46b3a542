"""Merge Pano360 crops with AGORA camera annotations into the
``pano_agora_dataset_{split}.npz`` files the PanoAgoraDataset consumes
(reference ``camcalib/pano_agora_dataset.py:48-99`` ``preprocess_data``).

AGORA supplies per-image (pitch, roll, focal); its vfov derives from the
1080p frame height: ``vfov = 2 * atan(1080 / (2 * f))`` (reference :75).

Port of ``spec_tpu/datagen/pano_agora.py``: host code,
the same draws in the same order, so the samples equal the JAX
package's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

AGORA_IMG_HEIGHT = 1080.0


def agora_vfov_from_focal(focal_px) -> np.ndarray:
    return 2.0 * np.arctan(AGORA_IMG_HEIGHT / (2.0 * np.asarray(focal_px)))


def merge_pano_agora(
    pano_folder: str,
    agora_annots: Dict[str, dict],
    out_folder: str,
    val_ratio: float = 0.05,
    seed: int = 0,
):
    """Args:
      pano_folder: output of a Pano360 crop generator ('pano' layout).
      agora_annots: {relative_imgname: {'pitch','roll','focal'}}.
    Writes pano_agora_dataset_{train,val}.npz with imgname/pitch/roll/vfov.
    """
    import joblib

    names: List[str] = []
    pitches: List[float] = []
    rolls: List[float] = []
    vfovs: List[float] = []
    is_val: List[bool] = []

    # Pano crops (vfov stored in degrees in the 'pano' layout). The
    # upstream generator split by SOURCE PANORAMA (crops of one pano are
    # near-identical scenes) — that split must be PRESERVED, not
    # randomly redrawn per crop, or val panoramas leak into train and
    # CamCalib val metrics stop measuring generalization.
    for split in ('train_images.pkl', 'val_images.pkl'):
        path = os.path.join(pano_folder, split)
        if not os.path.exists(path):
            continue
        for name in joblib.load(path):
            annot_path = os.path.join(
                pano_folder, 'annotations',
                name.replace('.jpg', '.json').replace('.png', '.json'))
            with open(annot_path) as f:
                a = json.load(f)
            names.append(os.path.join('images', name))
            pitches.append(float(a['pitch']))
            rolls.append(float(a['roll']))
            vfovs.append(float(np.radians(a['vfov'])))
            is_val.append(split == 'val_images.pkl')

    # AGORA images (no upstream split — assigned by val_ratio here).
    rng = np.random.RandomState(seed)
    agora_items = list(agora_annots.items())
    n_val_agora = max(1, int(len(agora_items) * val_ratio)) \
        if agora_items else 0
    agora_val = set(
        rng.permutation(len(agora_items))[:n_val_agora].tolist())
    for k, (name, a) in enumerate(agora_items):
        names.append(name)
        pitches.append(float(a['pitch']))
        rolls.append(float(a['roll']))
        vfovs.append(float(agora_vfov_from_focal(a['focal'])))
        is_val.append(k in agora_val)

    val_idx = {i for i, v in enumerate(is_val) if v}

    os.makedirs(out_folder, exist_ok=True)
    for split in ('train', 'val'):
        sel = [i for i in range(len(names))
               if (i in val_idx) == (split == 'val')]
        np.savez(
            os.path.join(out_folder, f'pano_agora_dataset_{split}.npz'),
            imgname=np.array([names[i] for i in sel]),
            pitch=np.array([pitches[i] for i in sel], np.float32),
            roll=np.array([rolls[i] for i in sel], np.float32),
            vfov=np.array([vfovs[i] for i in sel], np.float32))
    return len(names)
