"""Pano360 + AGORA CamCalib dataset (port of
``spec_tpu/data/pano_agora_dataset.py``): the annotations come from one
merged npz, ``pano_agora_dataset_{split}.npz`` (imgname, pitch, roll and
vfov in radians), instead of a JSON per image. Items, the decode cache,
DEVICE_JITTER and the buckets are those of
:class:`~spec_tpu_torch.data.pano_dataset.CameraRegressorDataset`."""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from spec_tpu_torch.data.pano_dataset import (
    aspect_resize,
    make_item,
    resized_bucket,
)


class PanoAgoraDataset:
    def __init__(
        self,
        dataset_folder: str,
        is_train: bool = True,
        min_size: int = 600,
        max_size: int = 1000,
        loss_type: str = 'kl',
        num_images: int = -1,
        pad_multiple: int = 64,
        seed: int = 0,
        decode_cache: int = 0,
        device_jitter: bool = False,
    ):
        from spec_tpu_torch.data.cache import FrameCache

        self.dataset_folder = dataset_folder
        self.is_train = is_train
        self.min_size = min_size
        self.max_size = max_size
        self.loss_type = loss_type
        self.pad_multiple = pad_multiple
        self._decode_cache = (FrameCache(decode_cache) if decode_cache
                              else None)
        self.device_jitter = bool(device_jitter)
        self.rng = np.random.RandomState(seed)

        split = 'train' if is_train else 'val'
        data = np.load(
            os.path.join(dataset_folder, f'pano_agora_dataset_{split}.npz'),
            allow_pickle=True)
        self.imgname = data['imgname']
        self.pitch = data['pitch'].astype(np.float32)
        self.roll = data['roll'].astype(np.float32)
        self.vfov = data['vfov'].astype(np.float32)
        if num_images > 0:
            sel = self.rng.choice(len(self.imgname), num_images,
                                  replace=False)
            self.imgname = self.imgname[sel]
            self.pitch, self.roll, self.vfov = (
                self.pitch[sel], self.roll[sel], self.vfov[sel])

    def __len__(self):
        return len(self.imgname)

    def _decode_resized(self, imgname: str):
        from PIL import Image

        pil_img = Image.open(imgname).convert('RGB')
        orig_shape = np.array(pil_img.size, np.int32)
        pil_img = aspect_resize(pil_img, self.min_size, self.max_size)
        return np.asarray(pil_img, np.uint8), orig_shape

    def __getitem__(self, index: int) -> dict:
        imgname = os.path.join(self.dataset_folder, str(self.imgname[index]))
        if self._decode_cache is not None:
            arr, orig_shape = self._decode_cache.get_or_compute(
                (imgname, self.min_size, self.max_size),
                lambda: self._decode_resized(imgname))
        else:
            arr, orig_shape = self._decode_resized(imgname)
        return make_item(arr, orig_shape, float(self.vfov[index]),
                         float(self.pitch[index]), float(self.roll[index]),
                         imgname, self.loss_type, self.is_train,
                         self.device_jitter, self.rng)

    def shape_buckets(self) -> dict:
        """{bucket (H, W): [indices]}, from the image headers only."""
        from PIL import Image

        buckets = defaultdict(list)
        for i in range(len(self.imgname)):
            path = os.path.join(self.dataset_folder, str(self.imgname[i]))
            with Image.open(path) as im:
                w, h = im.size
            buckets[resized_bucket(w, h, self.min_size, self.max_size,
                                   self.pad_multiple)].append(i)
        return dict(buckets)
