"""Pano360 crop generation, recipe v2 (reference
``camcalib/pano_preprocessing.py:231-393``): 12 crops per panorama with
sampled cameras, image + JSON annotation per crop, train/val split by
source panorama.

Sampling distributions (reference :231-256, :323-324):
  yaw  ~ U(0, 360 deg)
  pitch ~ N(0.046, 0.3) rad
  roll ~ N(0, 0.05) rad
  vfov ~ N(67.5 deg, 20 deg), clipped to (15 deg, 120 deg)
  resolution ~ {640x640, 750x600, 800x600, 900x600, 992x558, 558x992}
               with frequencies {0.2, 0.2, 0.2, 0.2, 0.1, 0.1}

Port of ``spec_tpu/datagen/pano_preprocessing.py``: host code,
the same draws in the same order, so the samples equal the JAX
package's.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from spec_tpu_torch.datagen.projection import equirect_to_perspective

RESOLUTIONS = [(640, 640), (600, 750), (600, 800), (600, 900),
               (558, 992), (992, 558)]  # (H, W)
RES_FREQS = [0.2, 0.2, 0.2, 0.2, 0.1, 0.1]


def sample_cam_params(rng: np.random.RandomState) -> dict:
    """One camera draw (reference sample_cam_params, :231-256)."""
    vfov = np.clip(rng.normal(np.radians(67.5), np.radians(20.0)),
                   np.radians(15.0), np.radians(120.0))
    return {
        'yaw': rng.uniform(0.0, 2 * np.pi),
        'pitch': rng.normal(0.046, 0.3),
        'roll': rng.normal(0.0, 0.05),
        'vfov': float(vfov),
        'resolution': RESOLUTIONS[rng.choice(len(RESOLUTIONS), p=RES_FREQS)],
    }


def preprocess_calib_data(
    pano_files: List[str],
    out_folder: str,
    crops_per_pano: int = 12,
    seed: int = 0,
    val_ratio: float = 0.1,
    writer=None,
    workers: int = 0,
) -> dict:
    """Generate crops + annots; split train/val by source pano
    (reference :286-393). ``writer(img, path)`` is injectable for tests.

    Panoramas are processed by a thread pool that scales with cores on a
    real host (cv2 decode/remap/encode release the GIL; projection
    measures ~130 ms/crop single-thread at 4k equirect, i.e. hours at
    Pano360 scale; workers defaults to min(8, cpu_count)). Each pano
    draws from its own (seed, index) RNG stream, so outputs are
    deterministic regardless of thread scheduling.

    Returns {'train_images': [...], 'val_images': [...]}.
    """
    import concurrent.futures as cf

    import cv2

    img_dir = os.path.join(out_folder, 'images')
    annot_dir = os.path.join(out_folder, 'annotations')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(annot_dir, exist_ok=True)
    writer = writer or (lambda img, path: cv2.imwrite(
        path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR)))

    n_val_panos = max(1, int(len(pano_files) * val_ratio)) \
        if len(pano_files) > 1 else 0
    val_panos = set(pano_files[:n_val_panos])

    def process_pano(pi_path):
        pi, pano_path = pi_path
        pano = cv2.cvtColor(cv2.imread(pano_path), cv2.COLOR_BGR2RGB)
        stem = os.path.splitext(os.path.basename(pano_path))[0]
        rng = np.random.RandomState([seed, pi])
        key = ('val_images' if pano_path in val_panos else 'train_images')
        out = []
        for k in range(crops_per_pano):
            cam = sample_cam_params(rng)
            try:
                crop = equirect_to_perspective(
                    pano, cam['vfov'], cam['pitch'], cam['roll'],
                    cam['yaw'], cam['resolution'])
            except Exception as e:  # reference logs per-image and continues
                with open(os.path.join(out_folder,
                                       f'{stem}_{k:02d}.error.txt'),
                          'w') as f:
                    f.write(str(e))
                continue
            name = f'{stem}_{k:02d}.jpg'
            writer(crop, os.path.join(img_dir, name))
            annot = {
                'pitch': float(cam['pitch']),
                'roll': float(cam['roll']),
                'vfov': float(np.degrees(cam['vfov'])),  # degrees ('pano')
                'yaw': float(cam['yaw']),
                'height': cam['resolution'][0],
                'width': cam['resolution'][1],
                'source': os.path.basename(pano_path),
            }
            # 'pano' layout: annotations/<name>.json, vfov in degrees
            # (reference pano_dataset.py:116-121).
            with open(os.path.join(annot_dir,
                                   name.replace('.jpg', '.json')), 'w') as f:
                json.dump(annot, f)
            out.append((key, name))
        return out

    workers = int(workers or min(8, os.cpu_count() or 1))
    splits = {'train_images': [], 'val_images': []}
    with cf.ThreadPoolExecutor(workers) as pool:
        for results in pool.map(process_pano, enumerate(pano_files)):
            for key, name in results:
                splits[key].append(name)

    import joblib
    for key, names in splits.items():
        joblib.dump(names, os.path.join(out_folder, f'{key}.pkl'))
    return splits


def main(argv=None):
    """``python -m spec_tpu_torch.datagen.pano_preprocessing <pano_dir> <out>``
    — the reference runs its generator as a script
    (camcalib/pano_preprocessing.py:396-426)."""
    import argparse
    import glob

    parser = argparse.ArgumentParser(
        description='Pano360 v2 perspective-crop generator')
    parser.add_argument('pano_dir', help='directory of equirect panoramas')
    parser.add_argument('out_folder')
    parser.add_argument('--crops_per_pano', type=int, default=12)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--val_ratio', type=float, default=0.1)
    parser.add_argument('--workers', type=int, default=0,
                        help='pano-level threads (0 = min(8, cpu_count))')
    args = parser.parse_args(argv)
    panos = sorted(
        p for ext in ('jpg', 'jpeg', 'png')
        for p in glob.glob(os.path.join(args.pano_dir, f'*.{ext}')))
    if not panos:
        raise SystemExit(f'no panoramas found in {args.pano_dir}')
    splits = preprocess_calib_data(
        panos, args.out_folder, crops_per_pano=args.crops_per_pano,
        seed=args.seed, val_ratio=args.val_ratio, workers=args.workers)
    print(f'[pano-datagen] wrote {len(splits["train_images"])} train '
          f'+ {len(splits["val_images"])} val crops to {args.out_folder}')


if __name__ == '__main__':
    main()
