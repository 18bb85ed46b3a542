"""Host-side SPIN crop geometry and the data loaders' image transforms
(port of ``spec_tpu/data/transforms.py``).

A bbox is (center, scale) with side = scale * 200 px; the crop maps that
box (optionally rotated about its center) to a res x res image. The
corner arithmetic stays in float64 exactly as in the reference: the
integer truncation of the crop corners sits on knife edges that float32
intermediates move. The training augmentations are the reference's:
rotation, flips of images, keypoints and poses, random sub-crops and
motion blur.

The reduced-scale decode of ``fast_decode`` (:func:`read_img` with
``reduce``, :func:`pick_reduce`, :func:`crop_from_reduced`) and the
native JPEG region-of-interest path (:func:`sample_window`,
:func:`native_jpeg_crops` over ``csrc/jpegroi.cpp``) are the
reference's. cv2 and PIL are imported inside the functions that decode
or resample (the machine with the card has neither).
"""

from __future__ import annotations

import numpy as np

from spec_tpu_torch.core import constants as C

BBOX_SIDE = 200.0  # SPIN convention: bbox pixel side = scale * 200


def get_transform(center, scale, res, rot=0):
    """3x3 float64 matrix mapping original-image points into the
    res x res crop (SPIN ``get_transform``): the scale * 200 box to res,
    then a rotation by ``rot`` degrees about the crop center."""
    h = BBOX_SIDE * scale
    t = np.zeros((3, 3), dtype=np.float64)
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot_rad = -rot * np.pi / 180.0  # counter-clockwise in image coords
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.eye(3)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert=0, rot=0):
    """Map a (2,) point image <-> crop (SPIN ``transform``), 1-based:
    callers pass pt + 1 and get a 1-based integer result."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1, pt[1] - 1, 1.0])
    return new_pt[:2].astype(int) + 1


def crop(img, center, scale, res, rot=0):
    """SPIN crop of ``img`` around (center, scale) to ``res`` (rows, cols).

    rot == 0: integer ul/br corners from the inverse point transform, a
    zero-padded slice, one bilinear resize; bit for bit the reference's
    path, whose preprocessing the metric budget relies on. rot != 0 (a
    training augmentation): one warpAffine with the composite map and
    zero borders, as the reference's."""
    import cv2

    if rot != 0:
        t = get_transform(center, scale, res, rot=rot)
        return cv2.warpAffine(
            img.astype(np.float32), t[:2, :].astype(np.float32),
            (int(res[1]), int(res[0])), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0)
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


def crop_affine(center, scale, res, rot=0):
    """The SPIN crop as a destination -> full-resolution-source affine:
    ``(aff (2, 3) float32, box (4,) float32 or None)``. rot == 0:
    destination (x, y) samples source ``((x + .5) * bw / res_w - .5 +
    ulx, ...)`` with the coordinates clamped to the integer SPIN box
    ``[x0, y0, x1, y1]`` (inclusive; the corners of :func:`crop`), the
    map of :func:`crop`'s slice and resize. rot != 0: the inverse of
    :func:`get_transform` and no box (zero borders)."""
    if rot != 0:
        t = get_transform(center, scale, res, rot=rot)
        return np.linalg.inv(t)[:2].astype(np.float32), None
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


_REDUCED_FLAGS = {}  # filled at the first reduced read: cv2 is optional


def read_img(path, reduce: int = 1):
    """RGB uint8 image (cv2 decode, BGR -> RGB). uint8 rather than the
    reference's float: :func:`crop` converts exactly, so crops are the
    same bits.

    ``reduce`` in {1, 2, 4, 8} decodes at 1/reduce scale
    (``cv2.IMREAD_REDUCED_COLOR_N``: libjpeg's DCT-domain scaling for
    JPEG; other formats decode full size and are downsampled). The
    result is ceil(full / reduce) on each side: the ``fast_decode``
    path."""
    import cv2

    if reduce == 1:
        flag = cv2.IMREAD_COLOR
    else:
        if not _REDUCED_FLAGS:
            _REDUCED_FLAGS.update({2: cv2.IMREAD_REDUCED_COLOR_2,
                                   4: cv2.IMREAD_REDUCED_COLOR_4,
                                   8: cv2.IMREAD_REDUCED_COLOR_8})
        flag = _REDUCED_FLAGS[reduce]
    img = cv2.imread(path, flag)
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


def pick_reduce(box_px: float, out_res: int, margin: float = 1.15,
                max_reduce: int = 8) -> int:
    """The largest decode reduction in {1, 2, 4, 8} that keeps the crop
    a downsample: box_px / reduce >= margin * out_res (the margin absorbs
    the decoder's ceil rounding and the SPIN corners' truncation, so the
    final bilinear resize never upsamples)."""
    r = 1
    while r * 2 <= max_reduce and box_px / (r * 2) >= margin * out_res:
        r *= 2
    return r


def crop_from_reduced(img, center, scale, res, reduce: int, rot=0):
    """SPIN crop sampled from a 1/reduce-decoded image, ``center`` and
    ``scale`` in full-resolution coordinates. Reduced pixel i covers full
    columns [i * r, (i + 1) * r), its center at i * r + (r - 1) / 2; the
    full-resolution crop window is mapped into that grid and warped in
    one pass, so it matches the full-resolution :func:`crop` to a
    sub-pixel (rescaling (center, scale) by 1/reduce instead would put
    the corner truncation on the coarser grid). rot == 0 replicates the
    slice and resize sampling of :func:`crop` (the same truncated
    corners, cv2.resize's center-aligned map); rot != 0 composes the
    augmentation's affine with the grid map. ``reduce`` 1 is
    :func:`crop`."""
    import cv2

    if reduce == 1:
        return crop(img, center, scale, res, rot=rot)
    off = (reduce - 1) / 2.0
    if rot == 0:
        ul = transform_point([1, 1], center, scale, res, invert=1) - 1
        br = transform_point([res[0] + 1, res[1] + 1], center, scale, res,
                             invert=1) - 1
        ax = (br[0] - ul[0]) / res[1]
        ay = (br[1] - ul[1]) / res[0]
        # dst (jx, jy) -> reduced src ((ax * jx + bx - off) / reduce, ...)
        M = np.array(
            [[ax / reduce, 0, (0.5 * ax - 0.5 + ul[0] - off) / reduce],
             [0, ay / reduce, (0.5 * ay - 0.5 + ul[1] - off) / reduce]],
            dtype=np.float32)
        return cv2.warpAffine(
            img.astype(np.float32), M, (int(res[1]), int(res[0])),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    grid = np.array([[reduce, 0, off], [0, reduce, off], [0, 0, 1.0]])
    t = get_transform(center, scale, res, rot=rot) @ grid
    return cv2.warpAffine(
        img.astype(np.float32), t[:2, :].astype(np.float32),
        (int(res[1]), int(res[0])), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0)


def sample_window(aff, box, res, frame_hw, reduce: int = 1,
                  margin: int = 2):
    """The smallest window of the 1/reduce grid holding every bilinear
    tap of the crop ``(aff, box)``: what the native ROI decode reads.
    Returns ``(x0, y0, w, h)`` clamped to the scaled frame, or None when
    the crop lies entirely outside the frame (the crop is all zeros)."""
    if box is not None:
        u0, v0, u1, v1 = (float(b) for b in box)
    else:
        res_h, res_w = int(res[0]), int(res[1])
        cs = np.array([[0, res_w - 1, 0, res_w - 1],
                       [0, 0, res_h - 1, res_h - 1],
                       [1, 1, 1, 1]], np.float64)
        uv = np.asarray(aff, np.float64) @ cs
        u0, u1 = uv[0].min(), uv[0].max()
        v0, v1 = uv[1].min(), uv[1].max()
    off = (reduce - 1) / 2.0
    x0 = int(np.floor((u0 - off) / reduce)) - margin
    x1 = int(np.ceil((u1 - off) / reduce)) + margin + 1
    y0 = int(np.floor((v0 - off) / reduce)) - margin
    y1 = int(np.ceil((v1 - off) / reduce)) + margin + 1
    rh = int(np.ceil(frame_hw[0] / reduce))
    rw = int(np.ceil(frame_hw[1] / reduce))
    x0, y0 = max(0, x0), max(0, y0)
    x1, y1 = min(rw, x1), min(rh, y1)
    if x1 <= x0 or y1 <= y0:
        return None
    return x0, y0, x1 - x0, y1 - y0


def native_jpeg_crops(data, plans, frame_hw, reduce: int = 1):
    """The fused native JPEG ROI decode and SPIN crop(s) of one frame
    (``csrc/jpegroi.cpp``; the caller has checked that the engine
    built). ``plans``: a list of ``(res, aff, box)``
    (:func:`crop_affine`). One plan decodes and samples in one native
    call; several (the eval path's display crop) decode the union window
    once and sample each crop from it. Crops whose window misses the
    frame are zeros (:func:`crop`'s zero padding). Returns a list of
    float32 ``(res_h, res_w, 3)`` crops in [0, 255], or None when the
    decode fails (the caller takes the cv2 path)."""
    from spec_tpu_torch import native

    wins = [sample_window(aff, box, res, frame_hw, reduce)
            for res, aff, box in plans]
    crops = [None] * len(plans)
    live = [i for i, w in enumerate(wins) if w is not None]
    for i, w in enumerate(wins):
        if w is None:
            res = plans[i][0]
            crops[i] = np.zeros((int(res[0]), int(res[1]), 3), np.float32)
    if not live:
        return crops
    if len(live) == 1:
        i = live[0]
        res, aff, box = plans[i]
        out = native.jpeg_roi_crop(data, wins[i], aff, res, box=box,
                                   reduce=reduce)
        if out is None:
            return None
        crops[i] = out
        return crops
    x0 = min(wins[i][0] for i in live)
    y0 = min(wins[i][1] for i in live)
    x1 = max(wins[i][0] + wins[i][2] for i in live)
    y1 = max(wins[i][1] + wins[i][3] for i in live)
    got = native.jpeg_decode_roi(data, x0, y0, x1 - x0, y1 - y0,
                                 reduce=reduce)
    if got is None:
        return None
    strip, _ = got
    for i in live:
        res, aff, box = plans[i]
        crops[i] = native.crop_affine_u8(strip, aff, res, box=box,
                                         reduce=reduce, origin=(x0, y0))
    return crops


def flip_img(img):
    """Horizontal flip."""
    return np.ascontiguousarray(img[:, ::-1])


def flip_kp(kp):
    """Flip 2D/3D keypoints of the 49-joint (or 24-joint) layout: swap
    left and right and negate x."""
    kp = kp[C.J49_FLIP_PERM] if kp.shape[0] == 49 else kp[C.J24_FLIP_PERM]
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose(pose):
    """Flip an SMPL axis-angle pose (72,): swap left and right joints
    and negate the y and z rotation components."""
    pose = pose[C.SMPL_POSE_FLIP_PERM]
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose


def rot_aa(aa, rot):
    """Rotate the global orientation (axis-angle) by an in-plane
    rotation of ``rot`` degrees."""
    if rot == 0:
        return aa
    import cv2

    rot_rad = -rot * np.pi / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    R = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], dtype=np.float64)
    per_rdg, _ = cv2.Rodrigues(aa.astype(np.float64))
    res_rot, _ = cv2.Rodrigues(R @ per_rdg)
    return res_rot.reshape(3).astype(aa.dtype)


def random_crop(center, scale, crop_scale_factor, axis='all', rng=None):
    """Shrink the bbox to a random sub-crop: side * crop_scale_factor,
    the center jittered so the sub-box stays inside the box; ``axis``
    ('all', 'x' or 'y') limits the jitter."""
    rng = rng or np.random
    h = BBOX_SIDE * scale
    new_h = h * crop_scale_factor
    space = (h - new_h) / 2.0
    new_center = np.asarray(center, np.float64).copy()
    if axis in ('all', 'x'):
        new_center[0] += rng.uniform(-space, space)
    if axis in ('all', 'y'):
        new_center[1] += rng.uniform(-space, space)
    return new_center, new_h / BBOX_SIDE


def motion_blur(img, rng, p=0.5, kernel_range=(3, 7)):
    """Albumentations' MotionBlur (the reference's): with probability
    ``p`` a line kernel of odd size in ``kernel_range``, random ends."""
    import cv2

    if rng.rand() >= p:
        return img
    k = int(rng.randint(kernel_range[0], kernel_range[1] + 1)) | 1
    kernel = np.zeros((k, k), np.float32)
    x1, y1 = rng.randint(0, k), rng.randint(0, k)
    x2, y2 = rng.randint(0, k), rng.randint(0, k)
    cv2.line(kernel, (x1, y1), (x2, y2), 1.0, thickness=1)
    s = kernel.sum()
    if s == 0:
        return img
    return cv2.filter2D(img, -1, kernel / s)
