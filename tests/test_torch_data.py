"""spec_tpu_torch.data's eval loader against spec_tpu.data's on the CPU:
the SPIN crop transforms, FrameCache, CamDataset items (against the
reference's ``native_decode=False`` cv2 path, on tests/test_goldens.py's
eval fixture and variants of it) and DataLoader batches (order, padding,
``_valid_count``, shuffling with ``group_keys``, ``skip_batches``).

Limits: crops bit for bit; every other item field exact or within 1e-6;
batches identical.
"""

import threading

import cv2
import numpy as np
import pytest
import torch

from spec_tpu.data import transforms as JT
from spec_tpu.data.cam_dataset import CamDataset as JaxCamDataset
from spec_tpu.data.loader import DataLoader as JaxDataLoader
from spec_tpu.data.loader import device_prefetch as jax_device_prefetch
from spec_tpu_torch.data import transforms as TT
from spec_tpu_torch.data.cache import FrameCache
from spec_tpu_torch.data.cam_dataset import CamDataset
from spec_tpu_torch.data.loader import DataLoader, collate, device_prefetch
from tests.test_goldens import _write_eval_fixture


@pytest.mark.parametrize('res', [(224, 224), (480, 480), (64, 96)])
def test_crop_matches_reference(res, rng):
    img = (rng.rand(120, 160, 3) * 255).astype(np.uint8)
    for center, scale in (((80.0, 60.0), 0.5), ((10.5, 100.2), 0.9),
                          ((150.0, 5.0), 0.31), ((80.0, 60.0), 2.0)):
        want = JT.crop(img, center, scale, list(res))
        got = TT.crop(img, center, scale, list(res))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        for a, b in zip(TT.crop_affine(center, scale, list(res)),
                        JT.crop_affine(center, scale, list(res))):
            np.testing.assert_array_equal(a, b)


def test_read_img_and_image_dims_match_reference(tmp_path, rng):
    path = str(tmp_path / 'a.png')
    cv2.imwrite(path, (rng.rand(37, 53, 3) * 255).astype(np.uint8))
    np.testing.assert_array_equal(TT.read_img(path), JT.read_img(path))
    np.testing.assert_array_equal(TT.image_dims(path), JT.image_dims(path))
    with pytest.raises(FileNotFoundError):
        TT.read_img(str(tmp_path / 'missing.png'))


def test_frame_cache_decodes_each_key_once_across_threads():
    cache = FrameCache(capacity=2)
    calls = []
    lock = threading.Lock()

    def decode(key):
        def fn():
            with lock:
                calls.append(key)
            return np.full(4, key)
        return fn

    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait(timeout=10)
        np.testing.assert_array_equal(
            cache.get_or_compute(i % 2, decode(i % 2)), np.full(4, i % 2))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert sorted(calls) == [0, 1]
    assert cache.hits + cache.misses == 8 and cache.misses == 2
    cache.get_or_compute(1, decode(1))            # key 0 is now the LRU
    cache.get_or_compute(2, decode(2))            # evicts key 0
    cache.get_or_compute(0, decode(0))
    assert calls.count(0) == 2


def _fixture(tmp_path, variant):
    """The golden's eval fixture; variants add gender, GT camera columns,
    keypoints or drop the camcalib columns."""
    annot, img_dir = _write_eval_fixture(str(tmp_path))
    if variant == 'golden':
        return annot, img_dir
    data = dict(np.load(annot))
    n = len(data['imgname'])
    rng = np.random.RandomState(3)
    if variant == 'gendered_gt_cam':
        data['gender'] = np.array(['m', 'f', 'f', 'm'])
        data['cam_rotmat'] = np.stack([np.linalg.qr(rng.randn(3, 3))[0]
                                       for _ in range(n)]).astype('f4')
        data['focal_length'] = (rng.rand(n) * 300 + 400).astype('f4')
        data['cam_pitch'] = rng.randn(n).astype('f4')
        data['cam_roll'] = rng.randn(n).astype('f4')
        data['cam_ext'] = rng.randn(n, 4, 4).astype('f4')
        data['openpose'] = np.concatenate(
            [rng.rand(n, 25, 2) * 100, rng.rand(n, 25, 1)], -1).astype('f4')
        data['has_smpl'] = np.array([1, 0, 1, 1], 'f4')
        data['part'][..., 2] = rng.rand(n, 24)
    elif variant == 'no_camcalib':
        for k in [k for k in data if k.startswith('camcalib_')]:
            del data[k]
        data['pose'] = data.pop('pose_0yaw_inverseyz')
    np.savez(annot, **data)
    return annot, img_dir


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ('load_time', 'proc_time'):
            continue
        g, w = got[k], want[k]
        if isinstance(w, str):
            assert g == w, k
        elif k in ('img', 'disp_img'):
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=0, atol=1e-6, err_msg=k)


CASES = {
    'golden': {},
    'gendered_gt_cam': {'emit_disp_img': True, 'render_res': 96},
    'no_camcalib': {'baseline_cam_c': True, 'decode_cache': 2},
    'baselines': {'baseline_cam_rot': True, 'baseline_cam_f': True,
                  'normalize': True},
    'subsample': {'num_images': 3, 'seed': 5, 'ignore_3d': True},
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_cam_dataset_items_match_reference(case, tmp_path):
    variant = case if case in ('golden', 'gendered_gt_cam',
                               'no_camcalib') else 'gendered_gt_cam'
    annot, img_dir = _fixture(tmp_path, variant)
    kw = CASES[case]
    want_ds = JaxCamDataset(annot, img_dir, dataset='3dpw-test-cam',
                            native_decode=False, **kw)
    # both on the cv2 path, the reference's parity oracle (the native
    # engine's items: tests/test_torch_native_loader.py)
    got_ds = CamDataset(annot, img_dir, dataset='3dpw-test-cam',
                        native_decode=False, **kw)
    assert len(got_ds) == len(want_ds)
    for name in ('pose', 'betas', 'has_smpl', 'gender', 'scale', 'center'):
        np.testing.assert_array_equal(getattr(got_ds, name),
                                      getattr(want_ds, name))
    for i in range(len(want_ds)):
        _assert_items_equal(got_ds[i], want_ds[i])


def test_use_3d_conf_copies_keypoint_confidences(tmp_path):
    from spec_tpu.data.cam_dataset import AugmentationConfig as JAug
    from spec_tpu_torch.data.cam_dataset import AugmentationConfig as TAug

    annot, img_dir = _fixture(tmp_path, 'gendered_gt_cam')
    want = JaxCamDataset(annot, img_dir, dataset='coco', native_decode=False,
                         aug=JAug(use_3d_conf=True))[1]
    got = CamDataset(annot, img_dir, dataset='coco', native_decode=False,
                     aug=TAug(use_3d_conf=True))[1]
    _assert_items_equal(got, want)
    assert not np.all(got['pose_conf'] == 1.0)


class _Items:
    """A dataset of small numbered items (the loader's own contract)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'x': np.full((2, 3), i, np.float32), 'i': np.int32(i),
                'imgname': f'f{i // 3}.jpg', 'dataset_name': 'd'}


LOADER_CASES = {
    'sequential': dict(batch_size=4),
    'drop_last': dict(batch_size=4, drop_last=True),
    'shuffled': dict(batch_size=4, shuffle=True, seed=7),
    'grouped': dict(batch_size=5, shuffle=True, seed=3, group_keys=True),
    'grouped_sequential': dict(batch_size=5, group_keys=True),
    'skip': dict(batch_size=3, shuffle=True, seed=1, skip_batches=2),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_data_loader_matches_reference(case):
    ds = _Items(14)
    kw = dict(LOADER_CASES[case])
    if kw.pop('group_keys', False):
        # keys shuffled so that groups are not contiguous in the dataset
        kw['group_keys'] = np.array([f'k{(i * 5) % 4}' for i in range(14)])
    ref = JaxDataLoader(ds, num_workers=3, **kw)
    port = DataLoader(ds, num_workers=3, **kw)
    assert len(port) == len(ref)
    for epoch in range(2):          # skip applies to the first epoch only
        want, got = list(ref), list(port)
        assert len(got) == len(want), epoch
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g['_valid_count'] == w['_valid_count']
            assert g['imgname'] == w['imgname']
            np.testing.assert_array_equal(g['x'], w['x'])
            np.testing.assert_array_equal(g['i'], w['i'])
        assert len(port) == len(ref)


def test_loader_pads_the_last_batch_and_surfaces_errors():
    batches = list(DataLoader(_Items(10), batch_size=4, num_workers=2))
    assert [b['_valid_count'] for b in batches] == [4, 4, 2]
    np.testing.assert_array_equal(batches[-1]['i'], [8, 9, 9, 9])

    class Broken(_Items):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError('bad item 5')
            return super().__getitem__(i)

    with pytest.raises(ValueError, match='bad item 5'):
        list(DataLoader(Broken(10), batch_size=4, num_workers=2))
    # a consumer that stops early leaves no producer blocked
    it = iter(DataLoader(_Items(40), batch_size=2, num_workers=2,
                         prefetch=1))
    next(it)
    it.close()


def test_collate_keeps_strings_as_lists():
    batch = collate([_Items(3)[i] for i in range(3)])
    assert batch['imgname'] == ['f0.jpg'] * 3
    assert batch['x'].shape == (3, 2, 3)


def test_device_prefetch_moves_arrays_and_passes_the_rest():
    batches = list(DataLoader(_Items(6), batch_size=4, num_workers=1))
    got = list(device_prefetch(iter(batches), 'cpu', tensor_keys=('x',)))
    want = list(jax_device_prefetch(iter(batches), tensor_keys=('x',)))
    assert len(got) == len(want) == 2
    for g, w, b in zip(got, want, batches):
        assert isinstance(g['x'], torch.Tensor)
        np.testing.assert_array_equal(g['x'].numpy(), np.asarray(w['x']))
        assert isinstance(g['i'], np.ndarray)       # not in tensor_keys
        assert g['imgname'] == b['imgname']
        assert g['_valid_count'] == b['_valid_count']
