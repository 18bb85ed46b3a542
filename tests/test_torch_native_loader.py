"""spec_tpu_torch's native JPEG engine (``csrc/jpegroi.cpp`` through
``spec_tpu_torch/native.py``), the reduced-scale decode and the region
cache of ``CamDataset`` against spec_tpu's on the CPU: the cases of
``tests/test_native_loader.py``.

* The ROI decode equals the same slice of a full cv2 decode bit for bit.
* ``crop_affine_u8`` against the Python/cv2 crop (the reference test's
  limits: < 0.5 of 255 for rot == 0; rotated mean < 0.5 and 99 % within
  4; the reduced grid mean < 1).
* Datasets: the port's native items equal spec_tpu's native items bit
  for bit (one source, one compiler, the same flags), and the port's
  native items are within ``ITEM_ATOL`` = 5e-4 of its cv2 items, the
  reference's limit (rotation: 2e-2, mean 1e-3).
* The region cache: ``raw`` bit-identical to the uncached native path
  over epochs, ``jpeg`` within a mean of 1e-2 (q95 re-encoding), the
  files persist across instances, cover the largest scale and rotation
  jitter, are refilled when stale or torn, are scoped per (dataset,
  split), and ``fast_decode`` with random sub-crops stays exact.

spec_tpu.native is built privately into a temporary directory (its
in-tree build races under xdist).
"""

import os

import cv2
import numpy as np
import pytest

from spec_tpu.data.cam_dataset import CamDataset as JaxCamDataset
from spec_tpu_torch import native
from spec_tpu_torch.data import transforms as T
from spec_tpu_torch.data.cam_dataset import AugmentationConfig, CamDataset

ITEM_ATOL = 5e-4


@pytest.fixture(autouse=True, scope='module')
def jax_native(tmp_path_factory):
    """spec_tpu.native built into a private path for this module."""
    import spec_tpu.native as JN

    saved = JN._SO, JN._lib, JN._failed
    JN._SO = str(tmp_path_factory.mktemp('jax_native') / '_native.so')
    JN._lib, JN._failed = None, False
    assert JN.available()
    yield JN
    JN._SO, JN._lib, JN._failed = saved


def _smooth_frame(rng, hw):
    """Photo-like frame (noise is JPEG's worst case and would make the
    q95 region-cache tolerance meaningless)."""
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    img = np.stack([
        127 + 100 * np.sin(xx / 60 + rng.rand() * 6)
        * np.cos(yy / 45 + rng.rand() * 6) for _ in range(3)], -1)
    img += rng.randn(*hw, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_dataset(tmp_path, n_frames=3, n=9, hw=(600, 900), seed=0,
                   smooth=False):
    rng = np.random.RandomState(seed)
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir(exist_ok=True)
    for i in range(n_frames):
        img = _smooth_frame(rng, hw) if smooth else \
            (rng.rand(*hw, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(img_dir / f'f{i}.jpg'), img)
    annot = dict(
        imgname=np.array([f'f{i % n_frames}.jpg' for i in range(n)]),
        scale=rng.uniform(0.6, 1.6, n).astype('f4'),
        center=np.stack([rng.uniform(100, hw[1] - 100, n),
                         rng.uniform(100, hw[0] - 100, n)], 1).astype('f4'),
        pose=(rng.randn(n, 72) * 0.2).astype('f4'),
        shape=(rng.randn(n, 10) * 0.5).astype('f4'),
        has_smpl=np.ones(n, 'f4'),
        S=rng.randn(n, 24, 4).astype('f4'),
        part=np.concatenate([rng.rand(n, 24, 2) * 500,
                             np.ones((n, 24, 1))], -1).astype('f4'),
        openpose=np.zeros((n, 25, 3), 'f4'),
    )
    npz = tmp_path / 'annots.npz'
    np.savez(npz, **annot)
    return str(npz), str(img_dir)


def _pair(npz, img_dir, **kw):
    a = CamDataset(npz, img_dir, '3dpw-test-cam', seed=7,
                   native_decode=True, **kw)
    b = CamDataset(npz, img_dir, '3dpw-test-cam', seed=7,
                   native_decode=False, **kw)
    return a, b


def _assert_items_close(ia, ib, atol=ITEM_ATOL):
    np.testing.assert_allclose(ia['img'], ib['img'], atol=atol)
    if 'disp_img' in ib:
        np.testing.assert_allclose(ia['disp_img'], ib['disp_img'],
                                   atol=atol)
    np.testing.assert_array_equal(ia['orig_shape'], ib['orig_shape'])
    np.testing.assert_array_equal(ia['keypoints'], ib['keypoints'])


def _assert_items_equal(ia, ib):
    for k in ('img', 'disp_img', 'orig_shape', 'keypoints', 'center',
              'scale', 'rot_angle'):
        if k in ib:
            np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)


# -- native primitives -------------------------------------------------------

def test_roi_decode_bit_exact_vs_cv2(tmp_path, rng):
    img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    p = str(tmp_path / 'f.jpg')
    cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, 92])
    data = np.fromfile(p, np.uint8)
    full = T.read_img(p)
    assert native.jpeg_probe(data) == (480, 640, 1, False)
    for (x0, y0, w, h) in [(100, 50, 200, 150), (0, 0, 640, 480),
                           (613, 450, 27, 30), (3, 470, 630, 10)]:
        strip, _ = native.jpeg_decode_roi(data, x0, y0, w, h)
        np.testing.assert_array_equal(strip, full[y0:y0 + h, x0:x0 + w])
    red = T.read_img(p, reduce=2)
    strip, _ = native.jpeg_decode_roi(data, 40, 30, 120, 100, reduce=2)
    np.testing.assert_array_equal(strip, red[30:130, 40:160])
    assert native.jpeg_probe(b'not a jpeg at all') is None


def test_crop_affine_matches_python_crop(rng):
    img = (rng.rand(300, 400, 3) * 255).astype(np.uint8)
    res = [224, 224]
    for center, scale in [([210.0, 160.0], 0.9), ([40.0, 20.0], 0.7),
                          ([390.0, 290.0], 1.3), ([200.0, 150.0], 0.31)]:
        aff, box = T.crop_affine(center, scale, res)
        out = native.crop_affine_u8(img, aff, res, box=box)
        ref = T.crop(img.astype(np.float32), center, scale, res)
        assert np.abs(out - ref).max() < 0.5
    for rot in (15.0, -47.0):
        aff, box = T.crop_affine([200.0, 150.0], 0.9, res, rot=rot)
        assert box is None
        out = native.crop_affine_u8(img, aff, res)
        ref = T.crop_from_reduced(img, [200.0, 150.0], 0.9, res, 1, rot=rot)
        assert np.abs(out - ref).mean() < 0.5
        assert (np.abs(out - ref) < 4).mean() > 0.99
    red = cv2.resize(img, (200, 150), interpolation=cv2.INTER_AREA)
    aff, box = T.crop_affine([200.0, 150.0], 0.6, res)
    out = native.crop_affine_u8(red, aff, res, box=box, reduce=2)
    ref = T.crop_from_reduced(red, [200.0, 150.0], 0.6, res, 2)
    assert np.abs(out - ref).mean() < 1.0


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'strided'])
def test_bindings_refuse_bad_arrays(bad, rng):
    img = (rng.rand(30, 40, 3) * 255).astype(np.uint8)
    aff, box = T.crop_affine([20.0, 15.0], 0.2, [16, 16])
    if bad == 'dtype':
        args, err = (img.astype(np.float32), aff), TypeError
    elif bad == 'shape':
        args, err = (img[..., :2].copy(), aff), ValueError
    else:
        args, err = (img[:, ::2], aff), ValueError
    with pytest.raises(err):
        native.crop_affine_u8(*args, [16, 16], box=box)


def test_sample_window_and_helpers_match_reference(rng):
    """The window, the reduce ladder and the reduced crop are the
    reference's functions; sampling only the window's strip reproduces
    the full-frame crop exactly."""
    from spec_tpu.data import transforms as JT

    img = (rng.rand(300, 400, 3) * 255).astype(np.uint8)
    res = [224, 224]
    for center, scale, rot in [([210.0, 160.0], 0.9, 0), ([40., 20.], 0.7, 0),
                               ([200.0, 150.0], 0.8, 33.0)]:
        aff, box = T.crop_affine(center, scale, res, rot=rot)
        for r in (1, 2, 4):
            assert T.sample_window(aff, box, res, img.shape[:2], r) == \
                JT.sample_window(aff, box, res, img.shape[:2], r)
            np.testing.assert_array_equal(
                T.crop_from_reduced(img, center, scale, res, r, rot=rot),
                JT.crop_from_reduced(img, center, scale, res, r, rot=rot))
        full = native.crop_affine_u8(img, aff, res, box=box)
        x0, y0, w, h = T.sample_window(aff, box, res, img.shape[:2])
        strip = np.ascontiguousarray(img[y0:y0 + h, x0:x0 + w])
        np.testing.assert_array_equal(
            native.crop_affine_u8(strip, aff, res, box=box, origin=(x0, y0)),
            full)
    for box_px in (100.0, 300.0, 600.0, 1200.0, 5000.0):
        assert T.pick_reduce(box_px, 224) == JT.pick_reduce(box_px, 224)


# -- CamDataset ---------------------------------------------------------------

@pytest.mark.parametrize('kw', [
    dict(is_train=False),
    dict(is_train=False, emit_disp_img=True, render_res=320),
    dict(is_train=True),
    dict(is_train=True, fast_decode=True),
    dict(is_train=False, emit_disp_img=True, render_res=320,
         fast_decode=True),
])
def test_dataset_native_vs_python_and_reference(tmp_path, kw):
    npz, img_dir = _write_dataset(tmp_path)
    a, b = _pair(npz, img_dir, **kw)
    j = JaxCamDataset(npz, img_dir, '3dpw-test-cam', seed=7,
                      native_decode=True, **kw)
    assert a._native_ok() and not b._native_ok() and j._native_ok()
    for i in range(len(a)):
        ia, ib, ij = a[i], b[i], j[i]
        _assert_items_close(ia, ib)
        _assert_items_equal(ia, ij)


def test_dataset_native_rotation_and_jitter(tmp_path):
    npz, img_dir = _write_dataset(tmp_path)
    aug = AugmentationConfig()
    aug.rot_factor = 30.0
    a, b = _pair(npz, img_dir, is_train=True, aug=aug)
    saw_rot = False
    for i in range(len(a)):
        ia, ib = a[i], b[i]
        saw_rot |= float(ib['rot_angle']) != 0.0
        assert float(ia['rot_angle']) == float(ib['rot_angle'])
        np.testing.assert_allclose(ia['img'], ib['img'], atol=2e-2)
        assert np.abs(ia['img'] - ib['img']).mean() < 1e-3
    assert saw_rot


def test_dataset_native_frame_cache_path(tmp_path):
    npz, img_dir = _write_dataset(tmp_path)
    a, b = _pair(npz, img_dir, is_train=False, decode_cache=4)
    j = JaxCamDataset(npz, img_dir, '3dpw-test-cam', seed=7,
                      native_decode=True, decode_cache=4)
    for i in range(len(a)):
        ia = a[i]
        _assert_items_close(ia, b[i])
        _assert_items_equal(ia, j[i])


def test_dataset_native_fallbacks(tmp_path):
    """A PNG under .jpg and an EXIF orientation-6 JPEG take the cv2
    decode per item and still match."""
    from PIL import Image

    rng = np.random.RandomState(3)
    npz, img_dir = _write_dataset(tmp_path, n_frames=2, n=4)
    img0 = (rng.rand(600, 900, 3) * 255).astype(np.uint8)
    ok, buf = cv2.imencode('.png', img0)
    assert ok
    with open(os.path.join(img_dir, 'f0.jpg'), 'wb') as f:
        f.write(buf.tobytes())
    img1 = (rng.rand(900, 600, 3) * 255).astype(np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(img1).save(os.path.join(img_dir, 'f1.jpg'),
                               exif=exif, quality=92)
    a, b = _pair(npz, img_dir, is_train=False)
    j = JaxCamDataset(npz, img_dir, '3dpw-test-cam', seed=7,
                      native_decode=True)
    for i in range(len(a)):
        ia = a[i]
        _assert_items_close(ia, b[i])
        _assert_items_equal(ia, j[i])


def test_native_decode_off_and_unbuildable_engine(tmp_path, monkeypatch,
                                                  capsys):
    """native_decode=False never builds or loads the engine; an engine
    that cannot build is reported once on stdout, and items come from
    cv2."""
    npz, img_dir = _write_dataset(tmp_path, n=2)
    off = CamDataset(npz, img_dir, '3dpw-test-cam', native_decode=False)
    assert not off._native_ok()
    from spec_tpu_torch.data import cam_dataset as CD

    monkeypatch.setattr(native, 'jpeg_engine',
                        lambda: (False, 'g++: no jpeglib.h'))
    CD._say_cv2_path.cache_clear()
    a = CamDataset(npz, img_dir, '3dpw-test-cam')
    b = CamDataset(npz, img_dir, '3dpw-test-cam')
    np.testing.assert_array_equal(a[0]['img'], off[0]['img'])
    b[0]
    out = capsys.readouterr().out
    assert out.count('native JPEG engine unavailable') == 1
    assert 'no jpeglib.h' in out and 'cv2' in out


# -- region cache -------------------------------------------------------------

def test_region_cache_raw_bit_identical(tmp_path):
    npz, img_dir = _write_dataset(tmp_path)
    cache_dir = str(tmp_path / 'rc')
    a = CamDataset(npz, img_dir, '3dpw-test-cam', seed=7, is_train=True,
                   native_decode=True, region_cache_dir=cache_dir,
                   region_cache_format='raw')
    b = CamDataset(npz, img_dir, '3dpw-test-cam', seed=7, is_train=True,
                   native_decode=True)
    j = JaxCamDataset(npz, img_dir, '3dpw-test-cam', seed=7, is_train=True,
                      native_decode=True,
                      region_cache_dir=str(tmp_path / 'rcj'),
                      region_cache_format='raw')
    for _epoch in range(2):
        for i in range(len(a)):
            ia = a[i]
            np.testing.assert_array_equal(ia['img'], b[i]['img'])
            np.testing.assert_array_equal(ia['img'], j[i]['img'])
    assert len(a._region_cache) == len(a)
    assert a._region_cache.hits >= len(a)
    assert sorted(os.listdir(a._region_cache.dir)) == \
        sorted(os.listdir(j._region_cache.dir))


def test_region_cache_jpeg_near_identical(tmp_path):
    npz, img_dir = _write_dataset(tmp_path, smooth=True)
    cache_dir = str(tmp_path / 'rcj')
    a = CamDataset(npz, img_dir, '3dpw-test-cam', seed=7, is_train=True,
                   native_decode=True, region_cache_dir=cache_dir)
    b = CamDataset(npz, img_dir, '3dpw-test-cam', seed=7, is_train=True,
                   native_decode=True)
    for _epoch in range(2):
        for i in range(len(a)):
            assert np.abs(a[i]['img'] - b[i]['img']).mean() < 1e-2
    files = os.listdir(a._region_cache.dir)
    assert len(files) == len(a) and all(f.endswith('.jpg') for f in files)


def test_region_cache_persists_across_instances(tmp_path):
    npz, img_dir = _write_dataset(tmp_path)
    kw = dict(seed=7, is_train=False, native_decode=True,
              region_cache_dir=str(tmp_path / 'rcp'),
              region_cache_format='raw')
    a = CamDataset(npz, img_dir, '3dpw-test-cam', **kw)
    items1 = [a[i]['img'] for i in range(len(a))]
    a2 = CamDataset(npz, img_dir, '3dpw-test-cam', **kw)
    assert len(a2._region_cache) == len(a2)
    items2 = [a2[i]['img'] for i in range(len(a2))]
    assert a2._region_cache.misses == 0
    for x, y in zip(items1, items2):
        np.testing.assert_array_equal(x, y)


def test_region_cache_covers_scale_jitter(tmp_path):
    npz, img_dir = _write_dataset(tmp_path, n=6)
    aug = AugmentationConfig()
    aug.rot_factor = 30.0
    aug.scale_factor = 0.25
    a = CamDataset(npz, img_dir, '3dpw-test-cam', seed=11, is_train=True,
                   aug=aug, native_decode=True,
                   region_cache_dir=str(tmp_path / 'rcw'),
                   region_cache_format='raw')
    b = CamDataset(npz, img_dir, '3dpw-test-cam', seed=11, is_train=True,
                   aug=aug, native_decode=True)
    for _epoch in range(4):
        for i in range(len(a)):
            np.testing.assert_array_equal(a[i]['img'], b[i]['img'])


def test_region_cache_stale_window_refills(tmp_path):
    npz, img_dir = _write_dataset(tmp_path, n=6)
    kw = dict(seed=11, is_train=True, native_decode=True,
              region_cache_dir=str(tmp_path / 'rcs'),
              region_cache_format='raw')
    small = AugmentationConfig()
    small.rot_factor = 0.0
    small.scale_factor = 0.0
    a = CamDataset(npz, img_dir, '3dpw-test-cam', aug=small, **kw)
    for i in range(len(a)):
        a[i]
    names_small = dict(a._region_cache._files)
    big = AugmentationConfig()
    big.rot_factor = 30.0
    big.scale_factor = 0.25
    a2 = CamDataset(npz, img_dir, '3dpw-test-cam', aug=big, **kw)
    b2 = CamDataset(npz, img_dir, '3dpw-test-cam', seed=11, is_train=True,
                    aug=big, native_decode=True)
    for _epoch in range(3):
        for i in range(len(a2)):
            np.testing.assert_array_equal(a2[i]['img'], b2[i]['img'])
    names_big = dict(a2._region_cache._files)
    assert any(names_big[i] != names_small[i] for i in names_small)
    assert set(names_big.values()) == set(os.listdir(a2._region_cache.dir))


def test_region_cache_torn_file_refills(tmp_path):
    npz, img_dir = _write_dataset(tmp_path, n=3)
    kw = dict(seed=7, is_train=False, native_decode=True,
              region_cache_dir=str(tmp_path / 'rct'),
              region_cache_format='raw')
    a = CamDataset(npz, img_dir, '3dpw-test-cam', **kw)
    ref = [a[i]['img'] for i in range(len(a))]
    name = a._region_cache._files[0]
    with open(os.path.join(a._region_cache.dir, name), 'wb') as f:
        f.write(b'torn')
    a2 = CamDataset(npz, img_dir, '3dpw-test-cam', **kw)
    np.testing.assert_array_equal(a2[0]['img'], ref[0])
    assert len(a2._region_cache) == len(a2)


def test_region_cache_scoped_per_dataset_and_split(tmp_path):
    npz, img_dir = _write_dataset(tmp_path, n=3)
    other = tmp_path / 'other'
    other.mkdir()
    npz2, img_dir2 = _write_dataset(other, n=3, seed=99)
    kw = dict(seed=7, is_train=False, native_decode=True,
              region_cache_dir=str(tmp_path / 'rcshared'),
              region_cache_format='raw')
    a = CamDataset(npz, img_dir, '3dpw-test-cam', **kw)
    b = CamDataset(npz2, img_dir2, 'spec-syn', **kw)
    ref_a = [a[i]['img'] for i in range(len(a))]
    ref_b = [b[i]['img'] for i in range(len(b))]
    assert a._region_cache.dir != b._region_cache.dir
    for i in range(len(a)):
        np.testing.assert_array_equal(a[i]['img'], ref_a[i])
        np.testing.assert_array_equal(b[i]['img'], ref_b[i])
    assert a._region_cache.misses == len(a)
    assert b._region_cache.misses == len(b)
    tr = CamDataset(npz, img_dir, '3dpw-test-cam', is_train=True, seed=7,
                    native_decode=True,
                    region_cache_dir=str(tmp_path / 'rcshared'),
                    region_cache_format='raw')
    assert tr._region_cache.dir != a._region_cache.dir


def test_region_cache_fast_decode_with_crop_aug(tmp_path):
    npz, img_dir = _write_dataset(tmp_path, n=4)
    d = dict(np.load(npz))
    d['scale'] = (d['scale'] * 2.5).astype('f4')   # engage the ladder
    np.savez(npz, **d)
    aug = AugmentationConfig()
    aug.scale_factor = 0.25
    aug.crop_prob = 1.0
    aug.crop_factor = 0.5
    aug.use_motion_blur = False
    kw = dict(seed=13, is_train=True, aug=aug, native_decode=True,
              fast_decode=True)
    a = CamDataset(npz, img_dir, '3dpw-test-cam',
                   region_cache_dir=str(tmp_path / 'rcfd'),
                   region_cache_format='raw', **kw)
    b = CamDataset(npz, img_dir, '3dpw-test-cam', **kw)
    for _epoch in range(3):
        for i in range(len(a)):
            np.testing.assert_array_equal(a[i]['img'], b[i]['img'])
    assert a._region_cache.hits >= 2 * len(a)
