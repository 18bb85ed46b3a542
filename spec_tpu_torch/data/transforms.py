"""Host-side SPIN crop geometry and the eval loader's image transforms
(the rot = 0 subset of ``spec_tpu/data/transforms.py``).

A bbox is (center, scale) with side = scale * 200 px; the crop maps that
box to a res x res image. The corner arithmetic stays in float64 exactly
as in the reference: the integer truncation of the crop corners sits on
knife edges that float32 intermediates move.

cv2 and PIL are imported inside the functions that decode or resample
(the machine with the card has neither). The training augmentations
(rotation, flips, random crops, motion blur) and the reduced-scale
decode are not ported yet (ROADMAP.md §1 item 9).
"""

from __future__ import annotations

import numpy as np

BBOX_SIDE = 200.0  # SPIN convention: bbox pixel side = scale * 200


def get_transform(center, scale, res):
    """3x3 float64 matrix mapping original-image points into the
    res x res crop (SPIN ``get_transform`` without rotation)."""
    h = BBOX_SIDE * scale
    t = np.zeros((3, 3), dtype=np.float64)
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    return t


def transform_point(pt, center, scale, res, invert=0):
    """Map a (2,) point image <-> crop (SPIN ``transform``), 1-based:
    callers pass pt + 1 and get a 1-based integer result."""
    t = get_transform(center, scale, res)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1, pt[1] - 1, 1.0])
    return new_pt[:2].astype(int) + 1


def crop(img, center, scale, res):
    """SPIN crop of ``img`` around (center, scale) to ``res`` (rows, cols):
    integer ul/br corners from the inverse point transform, a zero-padded
    slice, one bilinear resize. Bit for bit the reference's rot = 0 path,
    whose preprocessing the metric budget relies on."""
    import cv2

    ul = transform_point([1, 1], center, scale, res, invert=1) - 1
    br = transform_point([res[0] + 1, res[1] + 1], center, scale, res,
                         invert=1) - 1
    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if img.ndim > 2:
        new_shape += [img.shape[2]]
    new_img = np.zeros(new_shape, dtype=np.float32)
    new_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(img.shape[1], br[0])
    old_y = max(0, ul[1]), min(img.shape[0], br[1])
    if new_x[1] > new_x[0] and new_y[1] > new_y[0]:
        new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = \
            img[old_y[0]:old_y[1], old_x[0]:old_x[1]]
    return cv2.resize(new_img, (int(res[1]), int(res[0])),
                      interpolation=cv2.INTER_LINEAR)


def crop_affine(center, scale, res):
    """The SPIN crop as a destination -> full-resolution-source affine:
    ``(aff (2, 3) float32, box (4,) float32)``. Destination (x, y)
    samples source ``((x + .5) * bw / res_w - .5 + ulx, ...)`` with the
    coordinates clamped to the integer SPIN box ``[x0, y0, x1, y1]``
    (inclusive; the corners of :func:`crop`), the map of :func:`crop`'s
    slice and resize."""
    ul = transform_point([1, 1], center, scale, res, invert=1) - 1
    br = transform_point([res[0] + 1, res[1] + 1], center, scale, res,
                         invert=1) - 1
    bw, bh = br[0] - ul[0], br[1] - ul[1]
    ax, ay = bw / res[1], bh / res[0]
    aff = np.array([[ax, 0, 0.5 * ax - 0.5 + ul[0]],
                    [0, ay, 0.5 * ay - 0.5 + ul[1]]], np.float32)
    box = np.array([ul[0], ul[1], ul[0] + bw - 1, ul[1] + bh - 1],
                   np.float32)
    return aff, box


def read_img(path):
    """RGB uint8 image (cv2 decode, BGR -> RGB). uint8 rather than the
    reference's float: :func:`crop` converts exactly, so crops are the
    same bits."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def image_dims(path):
    """Full-resolution (H, W) float32 from the file header only, as
    :func:`read_img` decodes the file: cv2 applies the EXIF orientation,
    so for orientations 5-8 the header's dims are swapped."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
        try:
            orientation = im.getexif().get(0x0112, 1)
        except Exception:
            orientation = 1
    if orientation in (5, 6, 7, 8):
        w, h = h, w
    return np.array([h, w], np.float32)
