"""spec_tpu_torch's CamCalib training data against spec_tpu's, on the CPU.

A tiny synthetic pano set (JPEG crops of three sizes with JSON
annotations, in the 'pano_scalenet' and 'pano' layouts, and the merged
npz of the Pano+AGORA variant). Both packages read it with the same
seeds; the port's items must equal the reference's exactly (the same
PIL decode and resize, the same cv2 color transforms, the same
RandomState draws in the same order): images, jitter affines, targets
and shapes, in train and val mode, with and without DEVICE_JITTER,
the decode cache and the draft decode. Buckets, ``pad_collate`` and the
jitter helpers are held the same way, with no tolerance.
"""

import json
import os

import cv2
import joblib
import numpy as np
import pytest

from spec_tpu.data import pano_agora_dataset as JA
from spec_tpu.data import pano_dataset as JP
from spec_tpu_torch.data import pano_agora_dataset as TA
from spec_tpu_torch.data import pano_dataset as TP

# (h, w) of the crops: two buckets at MIN 64 / MAX 96, and one frame the
# draft decode reduces
SIZES = [(64, 80), (64, 80), (48, 96), (64, 80), (48, 96), (200, 256),
         (64, 80), (48, 96)]
MIN, MAX = 64, 96


def _write_set(root, dialect):
    rng = np.random.RandomState(0)
    img_dir = os.path.join(root, 'images')
    ann_dir = os.path.join(root, 'annotations')
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    names = []
    for i, (h, w) in enumerate(SIZES):
        nm = f'crop{i}.jpg'
        cv2.imwrite(os.path.join(img_dir, nm),
                    (rng.rand(h, w, 3) * 255).astype('u1'))
        ann = {'vfov': (40.0 + 5 * i) if dialect == 'pano'
               else 0.8 + 0.1 * i,
               'pitch': 0.05 * i - 0.2, 'roll': 0.03 * i - 0.1}
        where = ann_dir if dialect == 'pano' else img_dir
        with open(os.path.join(where, f'crop{i}.json'), 'w') as f:
            json.dump(ann, f)
        names.append(nm)
    joblib.dump(names[:6], os.path.join(root, 'train_images.pkl'))
    joblib.dump(names[6:], os.path.join(root, 'val_images.pkl'))
    for split, sel in (('train', slice(0, 6)), ('val', slice(6, None))):
        n = len(names[sel])
        np.savez(os.path.join(root, f'pano_agora_dataset_{split}.npz'),
                 imgname=np.array([f'images/{x}' for x in names[sel]]),
                 pitch=np.linspace(-0.2, 0.2, n),
                 roll=np.linspace(0.1, -0.1, n),
                 vfov=np.linspace(0.6, 1.4, n))
    return root


@pytest.fixture(scope='module', params=['pano_scalenet', 'pano'])
def pano_set(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    return _write_set(root, request.param), request.param


def _same_item(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


CASES = {
    'train': dict(is_train=True),
    'val': dict(is_train=False),
    'train device_jitter': dict(is_train=True, device_jitter=True),
    'val device_jitter': dict(is_train=False, device_jitter=True),
    'train fast_decode': dict(is_train=True, fast_decode=True),
    'train decode_cache': dict(is_train=True, decode_cache=8),
    'train ce subset': dict(is_train=True, loss_type='ce', num_images=4),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_camera_regressor_items_match(pano_set, case):
    root, dialect = pano_set
    kw = dict(dataset=dialect, min_size=MIN, max_size=MAX,
              loss_type='softargmax_biased_l2', seed=3)
    kw.update(CASES[case])
    want_ds = JP.CameraRegressorDataset(root, **kw)
    got_ds = TP.CameraRegressorDataset(root, **kw)
    assert len(got_ds) == len(want_ds)
    assert got_ds.image_filenames == want_ds.image_filenames
    for _ in range(2):          # a second epoch: cache hits, fresh jitter
        for i in range(len(want_ds)):
            _same_item(got_ds[i], want_ds[i])
    assert got_ds.shape_buckets() == want_ds.shape_buckets()
    if 'decode_cache' in case:
        assert got_ds._decode_cache.hits == len(got_ds)


@pytest.mark.parametrize('device_jitter', [False, True])
@pytest.mark.parametrize('is_train', [True, False])
def test_pano_agora_items_match(pano_set, is_train, device_jitter):
    root, _ = pano_set
    kw = dict(is_train=is_train, min_size=MIN, max_size=MAX, loss_type='kl',
              seed=5, decode_cache=2, device_jitter=device_jitter)
    want_ds = JA.PanoAgoraDataset(root, **kw)
    got_ds = TA.PanoAgoraDataset(root, **kw)
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        _same_item(got_ds[i], want_ds[i])
    assert got_ds.shape_buckets() == want_ds.shape_buckets()


@pytest.mark.parametrize('fixed', [False, True])
@pytest.mark.parametrize('device_jitter', [False, True])
def test_pad_collate_matches(pano_set, fixed, device_jitter):
    root, dialect = pano_set
    ds = TP.CameraRegressorDataset(root, dataset=dialect, min_size=MIN,
                                   max_size=MAX, device_jitter=device_jitter)
    items = [ds[i] for i in range(4)]
    hw = (128, 128) if fixed else None
    got = TP.pad_collate(items, fixed_hw=hw)
    want = JP.pad_collate(items, fixed_hw=hw)
    _same_item(got, want)
    assert got['img'].dtype == (np.uint8 if device_jitter else np.float32)
    h, w = items[1]['img'].shape[:2]
    assert got['pad_mask'][1, :h, :w].all()
    assert not got['pad_mask'][1, h:].any()
    assert not got['pad_mask'][1, :, w:].any()


@pytest.mark.parametrize('hw', [(480, 640), (720, 1280), (1080, 1920),
                                (600, 601), (1000, 333), (719, 1279)])
@pytest.mark.parametrize('minmax', [(600, 1000), (448, 1000), (384, 640)])
def test_bucket_rounding_matches(hw, minmax):
    """Buckets from the full-resolution size, with Python's round (halves
    to even): 720x1280 at MIN 600 / MAX 1000 scales by 0.78125 to
    562.5 -> 562 rows, bucket (576, 1024); 480x640 to 600x800, bucket
    (640, 832)."""
    h, w = hw
    s = JP.resize_scale(w, h, *minmax)
    assert TP.resize_scale(w, h, *minmax) == s
    want = (-(-round(h * s) // 64) * 64, -(-round(w * s) // 64) * 64)
    assert TP.resized_bucket(w, h, *minmax) == want
    assert TP.bucket_of((round(h * s), round(w * s))) == want
    if minmax == (600, 1000) and hw == (720, 1280):
        assert (round(h * s), round(w * s)) == (562, 1000)
        assert want == (576, 1024)
    if minmax == (600, 1000) and hw == (480, 640):
        assert want == (640, 832)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_jitter_helpers_match(seed):
    arr = (np.random.RandomState(seed).rand(30, 44, 3) * 255).astype('u1')
    A, b = TP.sample_jitter_affine(arr, np.random.RandomState(seed))
    Aw, bw = JP.sample_jitter_affine(arr, np.random.RandomState(seed))
    np.testing.assert_array_equal(A, Aw)
    np.testing.assert_array_equal(b, bw)
    np.testing.assert_array_equal(
        TP.jitter_normalize(arr, np.random.RandomState(seed)),
        JP.jitter_normalize(arr, np.random.RandomState(seed)))
    np.testing.assert_array_equal(TP.normalize_u8(arr), JP.normalize_u8(arr))
    from PIL import Image
    pil = Image.fromarray(arr)
    np.testing.assert_array_equal(
        np.asarray(TP.color_jitter(pil, np.random.RandomState(seed))),
        np.asarray(JP.color_jitter(pil, np.random.RandomState(seed))))
    np.testing.assert_array_equal(
        np.asarray(TP.aspect_resize(pil, 64, 96)),
        np.asarray(JP.aspect_resize(pil, 64, 96)))


@pytest.mark.parametrize('loss_type', ['ce', 'kl', 'softargmax_l2',
                                       'softargmax_biased_l2'])
def test_encode_targets_match(loss_type):
    for vfov, pitch, roll in ((0.3, -0.5, 0.4), (1.2, 0.0, -0.05),
                              (2.5, 0.7, -0.7)):
        got = TP.encode_targets(vfov, pitch, roll, loss_type)
        want = JP.encode_targets(vfov, pitch, roll, loss_type)
        _same_item(got, want)


def test_fast_decode_stays_in_its_bucket(tmp_path):
    """The draft decode's reduced size must not move an item out of the
    bucket ``shape_buckets`` predicted from the header."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, 'images'))
    names = []
    for i, (h, w) in enumerate([(720, 1280), (480, 640), (1080, 1920)]):
        nm = f'f{i}.jpg'
        cv2.imwrite(os.path.join(root, 'images', nm),
                    np.full((h, w, 3), 100, np.uint8))
        with open(os.path.join(root, 'images', f'f{i}.json'), 'w') as f:
            json.dump({'vfov': 1.0, 'pitch': 0.0, 'roll': 0.0}, f)
        names.append(nm)
    joblib.dump(names, os.path.join(root, 'train_images.pkl'))
    ds = TP.CameraRegressorDataset(root, min_size=600, max_size=1000,
                                   fast_decode=True, device_jitter=True)
    for bucket, idxs in ds.shape_buckets().items():
        for i in idxs:
            h, w = ds[i]['img'].shape[:2]
            assert ds.bucket_of((h, w)) == bucket
    assert set(ds.shape_buckets()) == {(576, 1024), (640, 832)}
