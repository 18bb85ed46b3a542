"""spec_tpu_torch's training data path against spec_tpu's on the CPU:
the training augmentations of ``data/transforms.py``, the occluders,
``CamDataset(is_train=True)`` items (against the reference's
``native_decode=False`` cv2 path), ``MixedCamDataset`` and the
DataLoader's train mode, on a synthetic npz + JPEG set with the same
seeds.

Limits: crops and every item field bit for bit (the same cv2 and numpy
calls on the same draws of the same RandomState); batches identical.
"""

import os

import cv2
import numpy as np
import pytest

from spec_tpu.data import occlusion as JO
from spec_tpu.data import transforms as JT
from spec_tpu.data.cam_dataset import AugmentationConfig as JaxAug
from spec_tpu.data.cam_dataset import CamDataset as JaxCamDataset
from spec_tpu.data.loader import DataLoader as JaxDataLoader
from spec_tpu.data.mixed_dataset import MixedCamDataset as JaxMixed
from spec_tpu.data.mixed_dataset import parse_datasets_ratios as jax_parse
from spec_tpu_torch.data import occlusion as TO
from spec_tpu_torch.data import transforms as TT
from spec_tpu_torch.data.cam_dataset import AugmentationConfig, CamDataset
from spec_tpu_torch.data.loader import DataLoader
from spec_tpu_torch.data.mixed_dataset import (
    MixedCamDataset,
    parse_datasets_ratios,
)

N = 6


def write_train_set(workdir, n=N, seed=11, name='annots.npz'):
    """A synthetic SPEC-style training set: JPEG frames (two persons on
    frame 0) and an npz with SMPL, 2D/3D keypoints and the GT camera."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(workdir, 'imgs')
    os.makedirs(img_dir, exist_ok=True)
    names = []
    for i in range(n):
        nm = f't{max(i - 1, 0)}.jpg'
        if not os.path.exists(os.path.join(img_dir, nm)):
            cv2.imwrite(os.path.join(img_dir, nm),
                        (rng.rand(120, 160, 3) * 255).astype('u1'))
        names.append(nm)
    annot = os.path.join(workdir, name)
    eye_ish = np.stack([np.linalg.qr(rng.randn(3, 3))[0]
                        for _ in range(n)]).astype('f4')
    np.savez(
        annot,
        imgname=np.array(names),
        scale=(rng.rand(n) * 0.3 + 0.4).astype('f4'),
        center=np.stack([rng.rand(n) * 60 + 50,
                         rng.rand(n) * 40 + 40], 1).astype('f4'),
        pose=(rng.randn(n, 72) * 0.2).astype('f4'),
        shape=(rng.randn(n, 10) * 0.5).astype('f4'),
        has_smpl=np.array([1, 1, 0, 1, 1, 1][:n], 'f4'),
        S=rng.randn(n, 24, 4).astype('f4'),
        part=np.concatenate([rng.rand(n, 24, 2) * 100,
                             rng.randint(0, 2, (n, 24, 1))],
                            -1).astype('f4'),
        openpose=np.concatenate([rng.rand(n, 25, 2) * 100,
                                 rng.rand(n, 25, 1)], -1).astype('f4'),
        gender=np.array(['m', 'f'] * (n // 2)),
        cam_rotmat=eye_ish,
        cam_pitch=(rng.randn(n) * 0.1).astype('f4'),
        cam_roll=(rng.randn(n) * 0.1).astype('f4'),
        focal_length=(rng.rand(n) * 300 + 400).astype('f4'),
    )
    return annot, img_dir


def _occluders(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 4) * 255).astype(np.uint8)
            for h, w in ((20, 12), (9, 30), (16, 16))]


AUG = dict(flip_prob=0.5, noise_factor=0.4, rot_factor=30.0,
           scale_factor=0.25, crop_prob=0.5, crop_factor=0.3,
           use_occlusion=True, use_motion_blur=True, use_3d_conf=False)


def _assert_items_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k in ('load_time', 'proc_time'):
            continue
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope='module')
def train_set(tmp_path_factory):
    return write_train_set(str(tmp_path_factory.mktemp('train')))


@pytest.mark.parametrize('variant', ['default_aug', 'full_aug',
                                     'baseline_cam', 'itw_3d_conf'])
def test_train_items_match_reference(train_set, variant):
    """Three passes over the set (the RandomState advances across
    items, so each pass draws new augmentations)."""
    annot, img_dir = train_set
    kw, aug = {}, {}
    dataset = 'spec-syn'
    if variant in ('full_aug', 'baseline_cam', 'itw_3d_conf'):
        aug = dict(AUG)
        kw['occluders'] = _occluders()
    if variant == 'baseline_cam':
        kw.update(baseline_cam_rot=True, baseline_cam_f=True,
                  baseline_cam_c=True)
    if variant == 'itw_3d_conf':
        aug['use_3d_conf'] = True
        dataset = 'coco'
    want_ds = JaxCamDataset(annot, img_dir, dataset, is_train=True,
                            img_res=64, aug=JaxAug(**aug), seed=5,
                            native_decode=False, **kw)
    got_ds = CamDataset(annot, img_dir, dataset, is_train=True, img_res=64,
                        aug=AugmentationConfig(**aug), seed=5,
                        native_decode=False, **kw)
    for _ in range(3):
        for i in range(N):
            _assert_items_equal(got_ds[i], want_ds[i])


def test_mixed_dataset_matches_reference(train_set, tmp_path):
    annot, img_dir = train_set
    annot2, img_dir2 = write_train_set(str(tmp_path), n=4, seed=12)
    assert parse_datasets_ratios('a_b-c_0.3_0.7') == jax_parse(
        'a_b-c_0.3_0.7')

    def members(cls, aug_cls, extra):
        return [cls(annot, img_dir, 'spec-syn', is_train=True, img_res=48,
                    aug=aug_cls(**AUG), seed=1, occluders=_occluders(),
                    **extra),
                cls(annot2, img_dir2, 'coco', is_train=True, img_res=48,
                    aug=aug_cls(), seed=2, **extra)]

    want = JaxMixed(members(JaxCamDataset, JaxAug,
                            {'native_decode': False}), [0.3, 0.7], seed=4)
    got = MixedCamDataset(members(CamDataset, AugmentationConfig,
                                  {'native_decode': False}),
                          [0.3, 0.7], seed=4)
    assert len(got) == len(want) == N
    np.testing.assert_array_equal(got.partition, want.partition)
    for i in list(range(N)) * 2:
        _assert_items_equal(got[i], want[i])


@pytest.mark.parametrize('kw', [
    dict(shuffle=True, drop_last=True, seed=3),
    dict(shuffle=True, drop_last=True, seed=3, skip_batches=1),
    dict(shuffle=True, drop_last=True, seed=2, group=True),
    dict(shuffle=False, drop_last=True, seed=0),
])
def test_train_loader_matches_reference(train_set, kw):
    """The trainer's loader (drop_last, the epoch's seed, a mid-epoch
    ``skip_batches``, frame ``group_keys``) yields the reference's
    batches: the same samples, in the same order, the same values."""
    annot, img_dir = train_set
    kw = dict(kw)
    group = kw.pop('group', False)
    want_ds = JaxCamDataset(annot, img_dir, 'spec-syn', is_train=True,
                            img_res=48, seed=9, native_decode=False)
    got_ds = CamDataset(annot, img_dir, 'spec-syn', is_train=True,
                        img_res=48, seed=9, native_decode=False)
    want = list(JaxDataLoader(
        want_ds, batch_size=2, num_workers=0,
        group_keys=want_ds.imgname if group else None, **kw))
    got = list(DataLoader(
        got_ds, batch_size=2, num_workers=0,
        group_keys=got_ds.imgname if group else None, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k not in ('load_time', 'proc_time'):
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


def test_transforms_match_reference():
    rng = np.random.RandomState(0)
    img = (rng.rand(90, 120, 3) * 255).astype(np.float32)
    for center, scale, rot in (((60.0, 45.0), 0.4, 17.0),
                               ((10.0, 80.0), 0.7, -40.0),
                               ((60.0, 45.0), 0.4, 0.0)):
        for res in ([64, 64], [48, 80]):
            np.testing.assert_array_equal(
                TT.get_transform(center, scale, res, rot=rot),
                JT.get_transform(center, scale, res, rot=rot))
            np.testing.assert_array_equal(
                TT.transform_point([30, 20], center, scale, res, invert=1,
                                   rot=rot),
                JT.transform_point([30, 20], center, scale, res, invert=1,
                                   rot=rot))
            np.testing.assert_array_equal(
                TT.crop(img, center, scale, res, rot=rot),
                JT.crop(img, center, scale, res, rot=rot))
            for a, b in zip(TT.crop_affine(center, scale, res, rot),
                            JT.crop_affine(center, scale, res, rot)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TT.flip_img(img), JT.flip_img(img))
    for shape in ((49, 3), (24, 4)):
        kp = rng.randn(*shape).astype('f4')
        np.testing.assert_array_equal(TT.flip_kp(kp.copy()),
                                      JT.flip_kp(kp.copy()))
    pose = rng.randn(72).astype('f4')
    np.testing.assert_array_equal(TT.flip_pose(pose.copy()),
                                  JT.flip_pose(pose.copy()))
    for rot in (0.0, 25.0, -60.0):
        aa = rng.randn(3).astype('f4')
        np.testing.assert_array_equal(TT.rot_aa(aa, rot), JT.rot_aa(aa, rot))
    for axis in ('all', 'x', 'y'):
        got = TT.random_crop([50.0, 40.0], 0.6, 0.7, axis=axis,
                             rng=np.random.RandomState(3))
        want = JT.random_crop([50.0, 40.0], 0.6, 0.7, axis=axis,
                              rng=np.random.RandomState(3))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for seed in range(6):
        np.testing.assert_array_equal(
            TT.motion_blur(img, np.random.RandomState(seed)),
            JT.motion_blur(img, np.random.RandomState(seed)))


def test_occlusion_matches_reference(tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(64, 64, 3) * 255).astype(np.float32)
    occ = _occluders()
    kp = np.concatenate([rng.uniform(-1, 1, (49, 2)),
                         rng.randint(0, 2, (49, 1))], -1).astype('f4')
    for seed in range(4):
        np.testing.assert_array_equal(
            TO.occlude_with_objects(img, occ, np.random.RandomState(seed),
                                    kp2d=kp, img_size=64),
            JO.occlude_with_objects(img, occ, np.random.RandomState(seed),
                                    kp2d=kp, img_size=64))
    path = str(tmp_path / 'occ.npz')
    np.savez(path, occluders=np.array(occ, dtype=object))
    for a, b in zip(TO.load_occluders(path), JO.load_occluders(path)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        TO.load_occluders(str(tmp_path / 'missing.pkl'))
