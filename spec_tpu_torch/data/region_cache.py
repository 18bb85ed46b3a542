"""Per-sample crop-region cache: decode each full frame once (port of
``spec_tpu/data/region_cache.py``).

Every sample only ever reads a deterministic region of its frame: the
SPIN crop box at the largest augmentation jitter. ``CamDataset(
region_cache_dir=...)`` stores that region per sample at its first touch
(the first epoch pays the normal decode) and serves later epochs from
the small region file instead of decoding the full frame. It needs the
native JPEG engine (``csrc/jpegroi.cpp``).

Region files live in one directory, the lookup metadata encoded in the
file name, so concurrent loader threads and several trainers on a shared
filesystem need no index file: writes go to a temporary file that
``os.replace`` renames into place (atomic); lookups are an in-memory dict
filled from one ``listdir`` at construction plus local inserts.

Formats:
  * ``jpeg`` (default): re-encoded at ``quality`` (95) with cv2. Lossy:
    the double-compression noise is far below the loader's own pixel
    noise augmentation (factor 0.4), but not bit-identical.
  * ``raw``: ``.npy`` uint8, bit-identical, about 10x the disk.
"""

from __future__ import annotations

import os
import threading

import numpy as np


class RegionCache:
    def __init__(self, cache_dir: str, fmt: str = 'jpeg',
                 quality: int = 95):
        if fmt not in ('jpeg', 'raw'):
            raise ValueError(f'fmt must be jpeg|raw, got {fmt!r}')
        self.dir = cache_dir
        self.fmt = fmt
        self.quality = int(quality)
        self._ext = '.jpg' if fmt == 'jpeg' else '.npy'
        self._lock = threading.Lock()
        os.makedirs(cache_dir, exist_ok=True)
        self._files = {}
        for name in os.listdir(cache_dir):
            if name.startswith('r') and name.endswith(self._ext):
                try:
                    # r{idx:08d}_...: the index grows past 8 digits, so
                    # parse up to the first '_'
                    idx = int(os.path.splitext(name)[0].split('_')[0][1:])
                except ValueError:
                    continue
                self._files[idx] = name
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._files)

    @staticmethod
    def _meta_from_name(name: str):
        # r{idx:08d}_{x0}_{y0}_{reduce}_{H}_{W}{ext}
        parts = os.path.splitext(name)[0].split('_')
        return {'x0': int(parts[1]), 'y0': int(parts[2]),
                'reduce': int(parts[3]),
                'full_hw': (int(parts[4]), int(parts[5]))}

    def get(self, index: int):
        """-> (region uint8 (h, w, 3), meta) or None. meta: x0/y0 (the
        region's origin on the 1/reduce grid), reduce, full_hw. A torn or
        corrupt file is dropped (the caller refills it)."""
        name = self._files.get(index)
        if name is None:
            self.misses += 1
            return None
        path = os.path.join(self.dir, name)
        try:
            if self.fmt == 'raw':
                region = np.load(path)
            else:
                from spec_tpu_torch import native

                data = np.fromfile(path, np.uint8)
                probe = native.jpeg_probe(data)
                if probe is None:
                    raise OSError('bad region jpeg')
                got = native.jpeg_decode_roi(data, 0, 0, probe[1], probe[0])
                if got is None:
                    raise OSError('bad region jpeg')
                region = got[0]
        except (OSError, ValueError):
            with self._lock:
                self._files.pop(index, None)
            self.misses += 1
            return None
        self.hits += 1
        return region, self._meta_from_name(name)

    def put(self, index: int, region: np.ndarray, x0: int, y0: int,
            reduce: int, full_hw) -> None:
        name = (f'r{index:08d}_{int(x0)}_{int(y0)}_{int(reduce)}'
                f'_{int(full_hw[0])}_{int(full_hw[1])}{self._ext}')
        path = os.path.join(self.dir, name)
        tmp = f'{path}.tmp{os.getpid()}.{threading.get_ident()}'
        try:
            if self.fmt == 'raw':
                np.save(tmp, np.ascontiguousarray(region, np.uint8))
                os.replace(tmp + '.npy', path)
            else:
                import cv2

                ok, buf = cv2.imencode(
                    '.jpg', cv2.cvtColor(region, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, self.quality])
                if not ok:
                    return
                with open(tmp, 'wb') as f:
                    f.write(buf.tobytes())
                os.replace(tmp, path)
        except OSError:
            return
        with self._lock:
            old = self._files.get(index)
            self._files[index] = name
        if old is not None and old != name:
            # refilled with another window (the augmentation bounds grew
            # between runs): remove the superseded file, or a later
            # listdir could bring the stale region back
            try:
                os.remove(os.path.join(self.dir, old))
            except OSError:
                pass
