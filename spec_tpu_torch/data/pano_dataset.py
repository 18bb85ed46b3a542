"""CamCalib training data: Pano360 perspective crops (port of
``spec_tpu/data/pano_dataset.py``).

The reference pads every image of a batch to the batch's largest; here,
as in the JAX package, images are padded to a grid of ``pad_multiple``
pixels (64) and batched within a bucket, so the train step has one input
signature, and one CUDA graph, per bucket. The model average-pools over
the padded map, as the reference's does: the padding is not masked.

Bucket sizes come from the full-resolution header dimensions through
:func:`resize_scale` and Python's ``round`` (halves to even: 720 x
0.78125 = 562.5 becomes 562), the same numbers ``__getitem__`` resizes
to, so an item never lands 1 pixel past its bucket.

Targets per loss type: integer bin indices (``np.digitize`` against the
edge tables) for 'ce'/'kl'; soft indices in [-1, 1] for the softargmax
losses. PIL, cv2 and joblib are imported where they are used.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from spec_tpu_torch.core import bins as B
from spec_tpu_torch.core import constants as C


def resize_scale(w: int, h: int, min_size: int, max_size: int) -> float:
    """torchvision's Resize(min_size) scale with a ``max_size`` cap: the
    one definition ``__getitem__``, ``shape_buckets`` and the draft
    decode's target all use."""
    s = min_size / min(w, h)
    if max(w, h) * s > max_size:
        s = max_size / max(w, h)
    return s


def aspect_resize(pil_img, min_size: int, max_size: int):
    """torchvision-semantics Resize(min_size) with a max_size cap."""
    from PIL import Image

    w, h = pil_img.size
    s = resize_scale(w, h, min_size, max_size)
    return pil_img.resize((round(w * s), round(h * s)), Image.BILINEAR)


def color_jitter(pil_img, rng: np.random.RandomState, brightness=0.2,
                 contrast=0.2, saturation=0.2, hue=0.1):
    """torchvision's ColorJitter with PIL's enhancers: random order, each
    factor U(1 - x, 1 + x), hue as a shift of PIL's uint8 HSV hue."""
    from PIL import Image, ImageEnhance

    ops = [('brightness', rng.uniform(1 - brightness, 1 + brightness)),
           ('contrast', rng.uniform(1 - contrast, 1 + contrast)),
           ('saturation', rng.uniform(1 - saturation, 1 + saturation)),
           ('hue', rng.uniform(-hue, hue))]
    rng.shuffle(ops)
    for name, f in ops:
        if name == 'brightness':
            pil_img = ImageEnhance.Brightness(pil_img).enhance(f)
        elif name == 'contrast':
            pil_img = ImageEnhance.Contrast(pil_img).enhance(f)
        elif name == 'saturation':
            pil_img = ImageEnhance.Color(pil_img).enhance(f)
        elif name == 'hue' and abs(f) > 1e-6:
            hsv = np.asarray(pil_img.convert('HSV')).copy()
            hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                           + int(f * 255)) % 256
            pil_img = Image.fromarray(hsv, 'HSV').convert('RGB')
    return pil_img


_GRAY_W = np.array([0.299, 0.587, 0.114], np.float32)  # ITU-R 601 (PIL L)


def sample_jitter_affine(arr_u8: np.ndarray, rng: np.random.RandomState,
                         brightness=0.2, contrast=0.2, saturation=0.2,
                         hue=0.1):
    """Draw one ColorJitter outcome as a pixel-space affine ``x -> A x +
    b`` (float64), with :func:`color_jitter`'s draws in its order.
    :func:`jitter_normalize` applies it on the host; DEVICE_JITTER items
    carry it to ``ops/preprocess.device_jitter_normalize``.

    brightness f: ``f x``; contrast f: ``f x + (1 - f) gray mean`` (the
    mean of a 4x-strided grid, tracked through the running affine);
    saturation f: ``(f I + (1 - f) 1 w^T) x``; hue: a rotation about the
    gray axis by ``2 pi f`` (the luma-preserving hue-rotate matrix)."""
    ops = [('brightness', rng.uniform(1 - brightness, 1 + brightness)),
           ('contrast', rng.uniform(1 - contrast, 1 + contrast)),
           ('saturation', rng.uniform(1 - saturation, 1 + saturation)),
           ('hue', rng.uniform(-hue, hue))]
    rng.shuffle(ops)

    mu = arr_u8[::4, ::4].reshape(-1, 3).mean(axis=0, dtype=np.float32)
    A = np.eye(3, dtype=np.float64)
    b = np.zeros(3, np.float64)
    for name, f in ops:
        if name == 'brightness':
            A *= f
            b *= f
        elif name == 'contrast':
            m = float(_GRAY_W @ (A @ mu + b))
            A *= f
            b = f * b + (1.0 - f) * m
        elif name == 'saturation':
            S = f * np.eye(3) + (1.0 - f) * np.outer(np.ones(3), _GRAY_W)
            A = S @ A
            b = S @ b
        elif name == 'hue' and abs(f) > 1e-6:
            th = 2.0 * np.pi * f
            c, s = np.cos(th), np.sin(th)
            H = np.array([
                [0.213 + 0.787 * c - 0.213 * s,
                 0.715 - 0.715 * c - 0.715 * s,
                 0.072 - 0.072 * c + 0.928 * s],
                [0.213 - 0.213 * c + 0.143 * s,
                 0.715 + 0.285 * c + 0.140 * s,
                 0.072 - 0.072 * c - 0.283 * s],
                [0.213 - 0.213 * c - 0.787 * s,
                 0.715 - 0.715 * c + 0.715 * s,
                 0.072 + 0.928 * c + 0.072 * s]])
            A = H @ A
            b = H @ b
    return A, b


def _norm_affine():
    """(x / 255 - mean) / std as a per-channel scale and bias (float32
    arithmetic on the float32 tables, as the reference computes them)."""
    scale = 1.0 / (255.0 * np.asarray(C.IMG_NORM_STD))
    bias = -np.asarray(C.IMG_NORM_MEAN) / np.asarray(C.IMG_NORM_STD)
    return scale, bias


def jitter_normalize(arr_u8: np.ndarray, rng: np.random.RandomState,
                     brightness=0.2, contrast=0.2, saturation=0.2,
                     hue=0.1) -> np.ndarray:
    """Color jitter and ImageNet normalize as one affine: the draw of
    :func:`sample_jitter_affine`, one clip to [0, 255], then
    ``(x / 255 - mean) / std``. cv2's color transform when cv2 imports,
    else numpy (as the reference)."""
    A, b = sample_jitter_affine(arr_u8, rng, brightness=brightness,
                                contrast=contrast, saturation=saturation,
                                hue=hue)
    scale, bias = _norm_affine()
    scale, bias = scale.astype(np.float32), bias.astype(np.float32)
    try:
        import cv2
        out = cv2.transform(np.asarray(arr_u8, np.float32),
                            np.hstack([A, b[:, None]]))
        np.clip(out, 0.0, 255.0, out=out)
        norm = np.hstack([np.diag(scale), bias[:, None]]).astype(np.float64)
        return cv2.transform(out, norm)
    except ImportError:
        x = np.asarray(arr_u8, np.float32).reshape(-1, 3)
        out = x @ A.T.astype(np.float32) + b.astype(np.float32)
        np.clip(out, 0.0, 255.0, out=out)
        out = out * scale + bias
        return out.reshape(arr_u8.shape)


def normalize_u8(arr_u8: np.ndarray) -> np.ndarray:
    """(x / 255 - mean) / std in one pass (cv2's color transform when
    cv2 imports, else numpy)."""
    scale, bias = _norm_affine()
    try:
        import cv2
        m = np.hstack([np.diag(scale), bias[:, None]])
        return cv2.transform(np.asarray(arr_u8, np.float32), m)
    except ImportError:
        return (np.asarray(arr_u8, np.float32) * scale.astype(np.float32)
                + bias.astype(np.float32))


def encode_targets(vfov, pitch, roll, loss_type: str) -> dict:
    """The train targets of one item: bin indices ('ce', 'kl') or soft
    indices (the softargmax losses)."""
    if loss_type in ('kl', 'ce'):
        return {
            'vfov': np.int32(B.angle_to_bin_index(vfov, B.VFOV_EDGES)),
            'pitch': np.int32(B.angle_to_bin_index(pitch, B.PITCH_EDGES)),
            'roll': np.int32(
                B.angle_to_bin_index(roll, B.LEGACY_ROLL_EDGES)),
        }
    return {
        'vfov': np.float32(B.vfov2soft_idx(vfov)),
        'pitch': np.float32(B.pitch2soft_idx(pitch)),
        'roll': np.float32(B.roll2soft_idx(roll)),
    }


def bucket_of(shape, pad_multiple: int = 64) -> tuple:
    """(h, w) -> the padded bucket (H, W), each rounded up to a multiple
    of ``pad_multiple``."""
    m = pad_multiple
    h, w = shape[:2]
    return (-(-h // m) * m, -(-w // m) * m)


def resized_bucket(w: int, h: int, min_size: int, max_size: int,
                   pad_multiple: int = 64) -> tuple:
    """The bucket of a ``w`` x ``h`` frame after the aspect resize."""
    s = resize_scale(w, h, min_size, max_size)
    return bucket_of((round(h * s), round(w * s)), pad_multiple)


def make_item(arr: np.ndarray, orig_shape, vfov: float, pitch: float,
              roll: float, imgname: str, loss_type: str, is_train: bool,
              device_jitter: bool, rng: np.random.RandomState) -> dict:
    """One training or validation item from a resized uint8 frame: host
    jitter and normalize (train), normalize (val), or the raw uint8 with
    its jitter affine (DEVICE_JITTER; the identity for val)."""
    item = {}
    if device_jitter:
        img = arr
        if is_train:
            A, b = sample_jitter_affine(arr, rng)
        else:
            A, b = np.eye(3), np.zeros(3)
        item['jitter_A'] = A.astype(np.float32)
        item['jitter_b'] = b.astype(np.float32)
    elif is_train:
        img = jitter_normalize(arr, rng)
    else:
        img = normalize_u8(arr)
    out = {
        'img': img,
        'imgname': imgname,
        'orig_shape': orig_shape,
        'vfov_angle': np.float32(vfov),
        'pitch_angle': np.float32(pitch),
        'roll_angle': np.float32(roll),
    }
    out.update(item)
    out.update(encode_targets(vfov, pitch, roll, loss_type))
    return out


class CameraRegressorDataset:
    """Pano360 crops with per-image JSON annotations: 'pano' keeps its
    JSON under ``annotations/`` with vfov in degrees, 'pano_scalenet'
    next to the image with vfov in radians.

    ``fast_decode``: decode JPEGs at PIL's nearest 1/2^k draft scale at
    least 1.15x the target, then resize down. ``decode_cache``: keep
    that many decoded and resized uint8 frames (before the jitter, so
    every epoch jitters anew). ``device_jitter``: items carry raw uint8
    and the jitter affine (``sample_jitter_affine``), applied on the
    device by the train step. ``num_images``: a subset drawn without
    replacement from ``RandomState(seed)``."""

    def __init__(
        self,
        dataset_folder: str,
        dataset: str = 'pano_scalenet',
        is_train: bool = True,
        min_size: int = 600,
        max_size: int = 1000,
        loss_type: str = 'kl',
        num_images: int = -1,
        pad_multiple: int = 64,
        seed: int = 0,
        fast_decode: bool = False,
        decode_cache: int = 0,
        device_jitter: bool = False,
    ):
        import joblib

        from spec_tpu_torch.data.cache import FrameCache

        self.dataset = dataset
        self.dataset_folder = dataset_folder
        self.is_train = is_train
        self.min_size = min_size
        self.max_size = max_size
        self.loss_type = loss_type
        self.pad_multiple = pad_multiple
        self.fast_decode = fast_decode
        self._decode_cache = (FrameCache(decode_cache) if decode_cache
                              else None)
        self.device_jitter = bool(device_jitter)
        self.rng = np.random.RandomState(seed)

        split = 'train_images.pkl' if is_train else 'val_images.pkl'
        self.image_filenames = list(
            joblib.load(os.path.join(dataset_folder, split)))
        if num_images > 0:
            n = min(num_images, len(self.image_filenames))
            self.image_filenames = list(self.rng.choice(
                self.image_filenames, n, replace=False))

    def __len__(self):
        return len(self.image_filenames)

    def _annot_path(self, imgname: str) -> str:
        if self.dataset == 'pano':
            return imgname.replace('images', 'annotations').replace(
                '.png', '.json').replace('.jpg', '.json')
        return imgname.rsplit('.', 1)[0] + '.json'

    def _decode_resized(self, imgname: str):
        """Decode and aspect-resize -> (uint8 RGB HWC, original (W, H)).
        The target comes from the full-resolution header dimensions, the
        numbers ``shape_buckets`` uses, also when the draft decode gives
        other ones."""
        from PIL import Image

        pil_img = Image.open(imgname)
        w0, h0 = pil_img.size
        s = resize_scale(w0, h0, self.min_size, self.max_size)
        target = (round(w0 * s), round(h0 * s))
        if self.fast_decode and s < 1.0:
            pil_img.draft(None, (int(np.ceil(w0 * s * 1.15)),
                                 int(np.ceil(h0 * s * 1.15))))
        pil_img = pil_img.convert('RGB')
        if pil_img.size != target:
            pil_img = pil_img.resize(target, Image.BILINEAR)
        return (np.asarray(pil_img, np.uint8),
                np.array((w0, h0), np.int32))

    def __getitem__(self, index: int) -> dict:
        imgname = os.path.join(self.dataset_folder, 'images',
                               self.image_filenames[index])
        if self._decode_cache is not None:
            arr, orig_shape = self._decode_cache.get_or_compute(
                (imgname, self.min_size, self.max_size),
                lambda: self._decode_resized(imgname))
        else:
            arr, orig_shape = self._decode_resized(imgname)
        with open(self._annot_path(imgname)) as f:
            data = json.load(f)
        pitch = float(data['pitch'])
        roll = float(data['roll'])
        vfov = (np.radians(float(data['vfov'])) if self.dataset == 'pano'
                else float(data['vfov']))
        return make_item(arr, orig_shape, vfov, pitch, roll, imgname,
                         self.loss_type, self.is_train, self.device_jitter,
                         self.rng)

    def bucket_of(self, shape) -> tuple:
        return bucket_of(shape, self.pad_multiple)

    def shape_buckets(self) -> dict:
        """{bucket (H, W): [indices]}, from the image headers only."""
        from PIL import Image

        buckets = defaultdict(list)
        for i, name in enumerate(self.image_filenames):
            path = os.path.join(self.dataset_folder, 'images', name)
            with Image.open(path) as im:
                w, h = im.size
            buckets[resized_bucket(w, h, self.min_size, self.max_size,
                                   self.pad_multiple)].append(i)
        return dict(buckets)


def pad_collate(items: Sequence[dict], pad_multiple: int = 64,
                fixed_hw: Optional[tuple] = None) -> dict:
    """Zero-pad the items' images to one bucket (``fixed_hw``, or the
    largest item's rounded up to ``pad_multiple``) and stack. The batch
    carries ``pad_mask`` (1 on the image) and ``true_shape`` (each
    item's (h, w)); uint8 images stay uint8."""
    shapes = np.array([it['img'].shape[:2] for it in items])
    if fixed_hw is None:
        m = pad_multiple
        H = int(-(-shapes[:, 0].max() // m) * m)
        W = int(-(-shapes[:, 1].max() // m) * m)
    else:
        H, W = fixed_hw
    imgs = np.zeros((len(items), H, W, 3), items[0]['img'].dtype)
    mask = np.zeros((len(items), H, W), np.float32)
    for i, it in enumerate(items):
        h, w = it['img'].shape[:2]
        imgs[i, :h, :w] = it['img']
        mask[i, :h, :w] = 1.0
    out = {'img': imgs, 'pad_mask': mask,
           'true_shape': shapes.astype(np.int32)}
    for k in items[0]:
        if k == 'img':
            continue
        vals = [it[k] for it in items]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out
