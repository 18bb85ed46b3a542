"""ctypes bindings of the port's host C++ (port of
``spec_tpu/native/__init__.py``): the z-buffer mesh rasterizer and the
ground plane's convex fill (``csrc/raster.cpp``), and the JPEG
region-of-interest decoder with its SPIN crop sampler
(``csrc/jpegroi.cpp``).

Each source is its own library, built with ``g++`` at first use by
``ops/cuda_build.build_host_library`` (never at import): the rasterizer
links nothing extra, the JPEG engine links libjpeg, so the renderer
builds on a machine without libjpeg. A failed build raises; there is no
cv2 fallback behind these functions. :func:`jpeg_engine` resolves once
whether the JPEG engine builds, for callers that choose between it and
cv2 (``data/cam_dataset.py``). ``spec_tpu/native/preproc.cpp`` (the JAX
predictor's host crop) has no counterpart: the port crops on the device.

Each binding checks its arrays' dtypes, shapes and contiguity and raises
on a mismatch, as the CUDA wrappers do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

_F32P = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
_I32P = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
_U8P = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')


def _check(name: str, arr, dtype, shape) -> None:
    """Raise unless ``arr`` is a C-contiguous ndarray of ``dtype`` whose
    shape matches ``shape`` (None entries match any size)."""
    if not isinstance(arr, np.ndarray):
        raise TypeError(f'{name} must be a numpy array, got {type(arr)}')
    if arr.dtype != dtype:
        raise TypeError(f'{name} must be {np.dtype(dtype)}, got {arr.dtype}')
    if len(arr.shape) != len(shape) or any(
            s is not None and s != a for a, s in zip(arr.shape, shape)):
        want = tuple('*' if s is None else s for s in shape)
        raise ValueError(f'{name} must have shape {want}, got {arr.shape}')
    if not arr.flags.c_contiguous:
        raise ValueError(f'{name} must be C-contiguous')


@functools.cache
def _raster() -> ctypes.CDLL:
    from spec_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library('raster')
    lib.raster_mesh.argtypes = [
        _F32P, ctypes.c_int,                    # verts_cam, V
        _I32P, ctypes.c_int,                    # faces, F
        _F32P, ctypes.c_int, ctypes.c_int,      # K, H, W
        _F32P, _F32P, ctypes.c_int,             # color, lights, n_lights
        _F32P, _U8P]                            # rgb_out, mask_out
    lib.raster_mesh.restype = None
    lib.fill_convex_poly.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # img, H, W, C
        _I32P, ctypes.c_int, _F32P]                        # pts, n, color
    lib.fill_convex_poly.restype = None
    return lib


@functools.cache
def _jpeg() -> ctypes.CDLL:
    from spec_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library('jpegroi')
    lib.jpeg_probe.argtypes = [_U8P, ctypes.c_long, _I32P]
    lib.jpeg_probe.restype = ctypes.c_int
    lib.jpeg_decode_roi.argtypes = [
        _U8P, ctypes.c_long, ctypes.c_int,      # bytes, n, reduce
        _I32P, _I32P,                           # x0 (inout), w (inout)
        ctypes.c_int, ctypes.c_int,             # y0, h
        _U8P, ctypes.c_int]                     # out, stride_px
    lib.jpeg_decode_roi.restype = ctypes.c_int
    lib.crop_affine_u8.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int,       # img, h, w
        ctypes.c_int,                           # reduce
        ctypes.c_float, ctypes.c_float,         # origin x, y
        _F32P, ctypes.c_int, ctypes.c_int,      # aff, res_h, res_w
        ctypes.c_int, _F32P, _F32P]             # box_clamp, box, out
    lib.crop_affine_u8.restype = None
    lib.jpeg_roi_crop.argtypes = [
        _U8P, ctypes.c_long, ctypes.c_int,      # bytes, n, reduce
        ctypes.c_int, ctypes.c_int,             # win_x0, win_y0
        ctypes.c_int, ctypes.c_int,             # win_w, win_h
        _F32P, ctypes.c_int, ctypes.c_int,      # aff, res_h, res_w
        ctypes.c_int, _F32P, _F32P]             # box_clamp, box, out
    lib.jpeg_roi_crop.restype = ctypes.c_int
    return lib


@functools.cache
def jpeg_engine() -> tuple[bool, str]:
    """(whether the JPEG engine built and loaded, why not). Resolved
    once per process; the build runs here, on the first call."""
    try:
        _jpeg()
    except (RuntimeError, OSError) as e:
        return False, ' '.join(str(e).split())[:400]
    return True, ''


# -- csrc/raster.cpp ---------------------------------------------------------


def raster_mesh(verts_cam: np.ndarray, faces: np.ndarray, K: np.ndarray,
                image_hw, base_color: np.ndarray, light_dirs: np.ndarray):
    """Z-buffer rasterization of a camera-frame mesh. ``verts_cam`` (V,
    3) float32, ``faces`` (F, 3) int32, ``K`` (3, 3) float32,
    ``base_color`` (3,) float32, ``light_dirs`` (L, 3) float32 unit
    directions. Returns (rgb float32 (H, W, 3) in [0, 1], zero outside
    the mask; mask bool (H, W))."""
    _check('verts_cam', verts_cam, np.float32, (None, 3))
    _check('faces', faces, np.int32, (None, 3))
    _check('K', K, np.float32, (3, 3))
    _check('base_color', base_color, np.float32, (3,))
    _check('light_dirs', light_dirs, np.float32, (None, 3))
    H, W = int(image_hw[0]), int(image_hw[1])
    rgb = np.zeros((H, W, 3), np.float32)
    mask = np.zeros((H, W), np.uint8)
    _raster().raster_mesh(
        verts_cam, verts_cam.shape[0], faces, faces.shape[0], K, H, W,
        base_color, light_dirs, light_dirs.shape[0], rgb, mask)
    return rgb, mask.astype(bool)


def fill_convex_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """Fill the convex polygon ``pts`` ((N, 2) int32 pixel vertices, x
    then y) with ``color`` in ``img`` ((H, W, C) float32, in place): the
    pixels ``cv2.fillConvexPoly(img, pts, color)`` sets (LINE_8, shift
    0)."""
    _check('img', img, np.float32, (None, None, None))
    _check('pts', pts, np.int32, (None, 2))
    H, W, C = img.shape
    color = np.ascontiguousarray(np.broadcast_to(
        np.asarray(color, np.float32), (C,)))
    _raster().fill_convex_poly(img, H, W, C, pts, pts.shape[0], color)


# -- csrc/jpegroi.cpp --------------------------------------------------------


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    _check('data', data, np.uint8, (None,))
    return data


def _box(box) -> np.ndarray:
    if box is None:
        return np.zeros(4, np.float32)
    _check('box', box, np.float32, (4,))
    return box


def jpeg_probe(data):
    """Header-only probe -> (H, W, exif_orientation, progressive), or
    None when the bytes are not decodable JPEG."""
    buf = _as_u8(data)
    out = np.zeros(4, np.int32)
    if _jpeg().jpeg_probe(buf, len(buf), out):
        return None
    return int(out[0]), int(out[1]), int(out[2]), bool(out[3])


def jpeg_decode_roi(data, x0: int, y0: int, w: int, h: int,
                    reduce: int = 1):
    """Rows [y0, y0 + h) and columns [x0, x0 + w) of the 1/reduce-scaled
    image. Returns (uint8 (h, w, 3) holding exactly that window, 0), or
    None on a decode error."""
    buf = _as_u8(data)
    stride_px = ((w + 31) // 32 + 2) * 32
    out = np.empty((h, stride_px, 3), np.uint8)
    ax = np.array([x0], np.int32)
    aw = np.array([w], np.int32)
    if _jpeg().jpeg_decode_roi(buf, len(buf), int(reduce), ax, aw, int(y0),
                               int(h), out, stride_px):
        return None
    lo = x0 - int(ax[0])
    return np.ascontiguousarray(out[:, lo:lo + w]), 0


def crop_affine_u8(img: np.ndarray, aff: np.ndarray, res_hw,
                   box: Optional[np.ndarray] = None, reduce: int = 1,
                   origin=(0.0, 0.0)) -> np.ndarray:
    """The SPIN crop sampler over an in-memory uint8 (h, w, 3) image or
    strip. ``aff`` (2, 3) float32: destination -> full-resolution source
    (``transforms.crop_affine``); ``box`` (4,) float32: the SPIN clamp
    box [x0, y0, x1, y1] (full resolution, inclusive) or None;
    ``reduce``/``origin`` place the strip on the full-resolution grid
    (strip pixel (0, 0) is reduced-grid pixel ``origin``). Returns
    (res_h, res_w, 3) float32 in [0, 255]."""
    _check('img', img, np.uint8, (None, None, 3))
    _check('aff', aff, np.float32, (2, 3))
    res_h, res_w = int(res_hw[0]), int(res_hw[1])
    out = np.empty((res_h, res_w, 3), np.float32)
    _jpeg().crop_affine_u8(img, img.shape[0], img.shape[1], int(reduce),
                           float(origin[0]), float(origin[1]), aff, res_h,
                           res_w, int(box is not None), _box(box), out)
    return out


def jpeg_roi_crop(data, window, aff: np.ndarray, res_hw,
                  box: Optional[np.ndarray] = None, reduce: int = 1):
    """Fused ROI decode + crop: decode only ``window`` ([x0, y0, w, h] on
    the 1/reduce grid, clamped to the scaled image, covering every
    bilinear tap: ``transforms.sample_window``) and sample the crop from
    it in one native call. Returns (res_h, res_w, 3) float32 in [0, 255],
    or None on a decode error."""
    buf = _as_u8(data)
    _check('aff', aff, np.float32, (2, 3))
    res_h, res_w = int(res_hw[0]), int(res_hw[1])
    out = np.empty((res_h, res_w, 3), np.float32)
    x0, y0, w, h = (int(v) for v in window)
    if _jpeg().jpeg_roi_crop(buf, len(buf), int(reduce), x0, y0, w, h, aff,
                             res_h, res_w, int(box is not None), _box(box),
                             out):
        return None
    return out
