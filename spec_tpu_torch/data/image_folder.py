"""Folder-of-images input for the CamCalib demo (port of
``spec_tpu/data/image_folder.py``).

torchvision ``Resize(min_size)`` semantics on the host with PIL (smaller
edge -> ``min_size``, bilinear), so the demo's pixels are the
reference's. The demo groups images by their resized shape and runs
each group as one batch. PIL is imported where an image is read (the
machine with the card has none).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import List, Sequence

import numpy as np

from spec_tpu_torch.core import constants as C

IMG_EXTS = ('.jpg', '.jpeg', '.png')


def list_images(folder: str) -> List[str]:
    return sorted(
        os.path.join(folder, x) for x in os.listdir(folder)
        if x.lower().endswith(IMG_EXTS) and not x.startswith('.'))


def resize_min_side(pil_img, min_size: int):
    """PIL image -> PIL image with the short side at ``min_size``."""
    from PIL import Image

    w, h = pil_img.size
    s = min_size / min(w, h)
    return pil_img.resize((round(w * s), round(h * s)), Image.BILINEAR)


def normalize_u8(arr_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 ``(x / 255 - mean) / std``."""
    scale = 1.0 / (255.0 * np.asarray(C.IMG_NORM_STD))
    bias = -np.asarray(C.IMG_NORM_MEAN) / np.asarray(C.IMG_NORM_STD)
    return (np.asarray(arr_u8, np.float32) * scale.astype(np.float32)
            + bias.astype(np.float32))


class ImageFolder:
    def __init__(self, image_list: Sequence[str], min_size: int = 600,
                 normalize: bool = True):
        self.image_filenames = list(image_list)
        self.min_size = min_size
        self.normalize = normalize

    def __len__(self):
        return len(self.image_filenames)

    def load_u8(self, index: int):
        """-> (resized uint8 RGB (H, W, 3), original (W, H))."""
        from PIL import Image

        with Image.open(self.image_filenames[index]) as im:
            pil_img = im.convert('RGB')
        orig = np.array(pil_img.size, np.int32)
        return np.asarray(resize_min_side(pil_img, self.min_size),
                          np.uint8), orig

    def __getitem__(self, index: int) -> dict:
        img, orig = self.load_u8(index)
        img = (normalize_u8(img) if self.normalize
               else np.asarray(img, np.float32) / 255.0)
        return {
            'img': img,                                       # HWC f32
            'imgname': self.image_filenames[index],
            'orig_shape': orig,                               # (W, H)
        }

    def shape_buckets(self) -> dict:
        """Group indices by resized (H, W) so each bucket is one
        static-shape batch. Reads only headers (PIL's lazy open)."""
        from PIL import Image

        buckets = defaultdict(list)
        for i, name in enumerate(self.image_filenames):
            with Image.open(name) as im:
                w, h = im.size
            s = self.min_size / min(w, h)
            buckets[(round(h * s), round(w * s))].append(i)
        return dict(buckets)
