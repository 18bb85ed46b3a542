"""ScaleNet-recipe Pano360 crop generator (reference
``camcalib/datagen/generateCalibrationDataset.py:58-126`` +
``image_extraction.py:28-161``).

Camera sampling — the 'myDistWider20200403' (SUNV2) regime that the
reference's active code uses (``generateCalibrationDataset.py:57-62``):
  focal (35mm-equiv) ~ lognormal(sigma=0.8, loc=14, scale=17),
  REJECTION-sampled into the open interval (12, 100) mm (the reference
  clips then re-loops on a strict inequality, so boundary atoms are
  resampled, :80-81); vfov = 2*atan2(sensor, 2*f35) with sensor height
  24 mm landscape / 36 mm portrait (35mm frame rotated, :99-109);
  horizon midline crossing ~ N(0.523, 0.3) rejection-sampled into
  (-1, 0.95) as a fraction of image height (:82-84) ->
  pitch = -atan((horizon - 0.5) * 24 / f35) — ALWAYS the 24 mm sensor,
  even for portrait crops, because the reference computes pitch before
  the portrait branch (:101-109);
  roll ~ Cauchy, scale 0.001 w.p. 0.33 (low-roll regime) else 0.1,
  rejection-sampled into (-pi/6, pi/6) (:59, :86-92);
  aspect w/h ~ {1:1, 5:4, 4:3, 3:2, 16:9} with probs
  {0.09, 0.01, 0.66, 0.20, 0.04} (:28-34), inverted for portrait
  (probability 0.20, :62,:104-107).

Output resolution: the reference passes ``output_height=600`` and
``ratio=ar`` to ``extractImage`` (:111-126), which builds a crop of
shape (600, round(600*ar)) (``image_extraction.py:133``) — height 600
always, width from the aspect. (The json 'height'/'width' fields the
reference writes (:151) are swapped/derived differently and do NOT match
the saved image; we store the actual crop shape instead.)

Port of ``spec_tpu/datagen/scalenet.py``: host code,
the same draws in the same order, so the samples equal the JAX
package's.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from spec_tpu_torch.datagen.projection import equirect_to_perspective

ASPECT_RATIOS = [1 / 1, 5 / 4, 4 / 3, 3 / 2, 16 / 9]   # w/h
ASPECT_PROBS = [0.09, 0.01, 0.66, 0.20, 0.04]
SENSOR_HEIGHT_MM = 24.0        # 35mm full frame is 36x24
SENSOR_HEIGHT_PORTRAIT_MM = 36.0
ROLL_SCALE_LOW, ROLL_SCALE, ROLL_LOW_PROB = 0.001, 0.1, 0.33


def _rejection(draw, lo, hi):
    """Redraw until strictly inside (lo, hi) — reference :80-92 loops on
    strict inequalities, so there are no probability atoms at the bounds."""
    x = np.inf
    while not lo < x < hi:
        x = draw()
    return float(x)


def sample_scalenet_cam(rng: np.random.RandomState, base_h: int = 600):
    """One ScaleNet camera draw. Returns dict incl. derived vfov/pitch."""
    f35 = _rejection(lambda: 14.0 + 17.0 * np.exp(0.8 * rng.randn()),
                     12.0, 100.0)
    horizon = _rejection(lambda: rng.normal(0.523, 0.3), -1.0, 0.95)

    scale = ROLL_SCALE_LOW if rng.rand() < ROLL_LOW_PROB else ROLL_SCALE
    # Cauchy(0, scale) via inverse CDF of a uniform draw.
    roll = _rejection(lambda: scale * np.tan(np.pi * (rng.rand() - 0.5)),
                      -np.pi / 6, np.pi / 6)

    yaw = float(rng.uniform(-np.pi, np.pi))
    ar = ASPECT_RATIOS[rng.choice(len(ASPECT_RATIOS), p=ASPECT_PROBS)]

    sensor = SENSOR_HEIGHT_MM
    vfov = 2.0 * np.arctan2(sensor, 2.0 * f35)
    # Pitch uses the 24 mm sensor height regardless of orientation
    # (reference computes fl_px before the portrait branch, :101-109).
    pitch = float(-np.arctan((horizon - 0.5) * SENSOR_HEIGHT_MM / f35))

    portrait = rng.rand() < 0.2
    if portrait:
        ar = 1.0 / ar
        sensor = SENSOR_HEIGHT_PORTRAIT_MM
        vfov = 2.0 * np.arctan2(sensor, 2.0 * f35)

    h, w = base_h, int(round(base_h * ar))
    return {
        'f35': f35, 'vfov': float(vfov), 'pitch': pitch, 'roll': roll,
        'horizon': horizon, 'yaw': yaw, 'sensor_size': float(sensor),
        'resolution': (h, w),
    }


def generate_calibration_dataset(
    pano_files: List[str],
    out_folder: str,
    crops_per_pano: int = 12,
    seed: int = 0,
    val_ratio: float = 0.1,
    debug: bool = False,
    workers: int = 0,
) -> dict:
    """Crops + per-image JSONs in the 'pano_scalenet' layout (json next to
    the jpg, vfov in radians — reference pano_dataset.py:122-127).

    ``debug=True`` additionally writes ``debug/<name>`` copies with the GT
    horizon line + angle text burned in, for visual QA of the sampled
    geometry (reference ``generateCalibrationDataset.py:119-136`` +
    ``debugging.py`` ``showHorizonLine``)."""
    import cv2
    import joblib

    img_dir = os.path.join(out_folder, 'images')
    os.makedirs(img_dir, exist_ok=True)
    if debug:
        from spec_tpu_torch.utils.vis import draw_horizon_line
        dbg_dir = os.path.join(out_folder, 'debug')
        os.makedirs(dbg_dir, exist_ok=True)
    n_val = max(1, int(len(pano_files) * val_ratio)) \
        if len(pano_files) > 1 else 0
    val_panos = set(pano_files[:n_val])

    def process_pano(pi_path):
        """One panorama end-to-end: decode -> crops_per_pano projections
        -> jpg + json (+ debug overlay). cv2 decode/remap/encode release
        the GIL, so pano-level threads scale with cores on a real host
        (~130 ms/crop single-thread at 4k equirect -> hours at Pano360
        scale); workers defaults to min(8, cpu_count). Deterministic
        regardless of scheduling: each pano draws from its own
        (seed, index) RNG stream."""
        pi, pano_path = pi_path
        # Per-pano fault isolation (the sibling generator in
        # pano_preprocessing logs and continues for the same reason): one
        # corrupt jpg must not abort a multi-hour generation run with
        # nothing written.
        raw = cv2.imread(pano_path)
        if raw is None:
            print(f'[scalenet-datagen] unreadable panorama skipped: '
                  f'{pano_path}')
            return []
        pano = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
        stem = os.path.splitext(os.path.basename(pano_path))[0]
        rng = np.random.RandomState([seed, pi])
        key = ('val_images' if pano_path in val_panos else 'train_images')
        out = []
        for k in range(crops_per_pano):
            cam = sample_scalenet_cam(rng)
            crop = equirect_to_perspective(
                pano, cam['vfov'], cam['pitch'], cam['roll'], cam['yaw'],
                cam['resolution'])
            name = f'{stem}_sn_{k:02d}.jpg'
            cv2.imwrite(os.path.join(img_dir, name),
                        cv2.cvtColor(crop, cv2.COLOR_RGB2BGR))
            if debug:
                overlay = draw_horizon_line(
                    crop, cam['vfov'], cam['pitch'], cam['roll'])
                cv2.imwrite(os.path.join(dbg_dir, name),
                            cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
            with open(os.path.join(img_dir, name.replace('.jpg', '.json')),
                      'w') as f:
                json.dump({
                    'pitch': cam['pitch'], 'roll': cam['roll'],
                    'vfov': cam['vfov'],  # radians (pano_scalenet)
                    'focal_length_35mm_eq': cam['f35'],
                    # reference :101 computes fl_px before the portrait
                    # branch, so it is always focal/24
                    'f_px': cam['f35'] / SENSOR_HEIGHT_MM,
                    'sensor_size': cam['sensor_size'],
                    'horizon': cam['horizon'], 'yaw': cam['yaw'],
                }, f)
            out.append((key, name))
        return out

    import concurrent.futures as cf
    workers = int(workers or min(8, os.cpu_count() or 1))
    splits = {'train_images': [], 'val_images': []}
    with cf.ThreadPoolExecutor(workers) as pool:
        for results in pool.map(process_pano, enumerate(pano_files)):
            for key, name in results:
                splits[key].append(name)

    for key, names in splits.items():
        joblib.dump(names, os.path.join(out_folder, f'{key}.pkl'))
    return splits


def main(argv=None):
    """``python -m spec_tpu_torch.datagen.scalenet <pano_dir> <out>`` — the
    reference runs its generator as a script
    (camcalib/datagen/generateCalibrationDataset.py:187-216)."""
    import argparse
    import glob

    parser = argparse.ArgumentParser(
        description='ScaleNet-recipe Pano360 crop generator')
    parser.add_argument('pano_dir', help='directory of equirect panoramas')
    parser.add_argument('out_folder')
    parser.add_argument('--crops_per_pano', type=int, default=12)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--val_ratio', type=float, default=0.1)
    parser.add_argument('--debug', action='store_true',
                        help='also write horizon-overlay QA images')
    parser.add_argument('--workers', type=int, default=0,
                        help='pano-level threads (0 = min(8, cpu_count))')
    args = parser.parse_args(argv)
    panos = sorted(
        p for ext in ('jpg', 'jpeg', 'png')
        for p in glob.glob(os.path.join(args.pano_dir, f'*.{ext}')))
    if not panos:
        raise SystemExit(f'no panoramas found in {args.pano_dir}')
    splits = generate_calibration_dataset(
        panos, args.out_folder, crops_per_pano=args.crops_per_pano,
        seed=args.seed, val_ratio=args.val_ratio, debug=args.debug,
        workers=args.workers)
    print(f'[scalenet-datagen] wrote {len(splits["train_images"])} train '
          f'+ {len(splits["val_images"])} val crops to {args.out_folder}')


if __name__ == '__main__':
    main()
