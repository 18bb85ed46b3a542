"""Camera-annotated person-crop dataset, eval mode (port of
``spec_tpu/data/cam_dataset.py``).

A struct-of-arrays annotation store over one npz and a host
``__getitem__`` that decodes and crops; the GT SMPL forwards, the
ImageNet normalization and the metrics run in the batched eval step on
the device (``eval/eval_loop.py``).

npz contract: imgname, scale, center; pose or pose_0yaw_inverseyz (the
yaw-normalized world pose, preferred), shape, has_smpl; S (24 x 4 3D
joints); part (24 x 3) and openpose (25 x 3) 2D keypoints; gender
('m' / 'f'); focal_length, cam_rotmat, cam_pitch, cam_roll, cam_ext,
cam_int (the GT camera); camcalib_{pitch,roll,vfov,f_pix} (CamCalib's
predictions); pose_cam (camera-frame GT pose, for the offline metrics).

Decoding is cv2's: the reference's ``native_decode=False`` path, which is
its parity oracle. Its native JPEG region-of-interest engine
(``spec_tpu/native``) has no counterpart in the port, so
``native_decode`` selects this one path whatever its value. Training
mode (``is_train=True``), ``occluders``, ``fast_decode`` and
``region_cache_dir`` are not ported yet (ROADMAP.md §1 item 9) and
raise.
"""

from __future__ import annotations

import dataclasses
import time
from os.path import join
from typing import Optional

import numpy as np

from spec_tpu_torch.core.geometry import euler_pitch_roll_np
from spec_tpu_torch.data import transforms as T
from spec_tpu_torch.data.cache import FrameCache

_ITEM9 = 'is not ported yet (ROADMAP.md §1 item 9, training)'


@dataclasses.dataclass
class AugmentationConfig:
    """The reference's augmentation settings. Eval mode applies none of
    them; ``use_3d_conf`` copies 2D keypoint confidences onto the pose
    and 3D joints of in-the-wild datasets in either mode."""

    flip_prob: float = 0.0
    noise_factor: float = 0.4
    rot_factor: float = 0.0
    scale_factor: float = 0.25
    crop_prob: float = 0.0
    crop_factor: float = 0.0
    use_occlusion: bool = False
    use_motion_blur: bool = True
    use_3d_conf: bool = False


class _NpzView(dict):
    """Dict with an NpzFile-style ``files`` attribute (subsampled
    annotations held in memory)."""

    @property
    def files(self):
        return list(self.keys())


class CamDataset:
    """Map-style eval dataset over one annotation npz.

    Args: those of ``spec_tpu.data.CamDataset``. ``annot_file`` (npz),
    ``img_dir`` (the root of its imgnames), ``dataset`` (the name tag:
    '3dpw-test-cam', 'spec-syn', ...), ``img_res`` (224), ``normalize``
    (ImageNet-normalize on the host; the eval step normalizes on the
    device), ``baseline_cam_rot`` / ``_f`` / ``_c`` (the
    DATASET.BASELINE_CAM_* ablations), ``render_res`` and
    ``emit_disp_img`` (a second, render_res crop per item),
    ``num_images`` (a seeded subsample without replacement),
    ``decode_cache`` (a decoded-frame LRU of that many frames).
    """

    def __init__(
        self,
        annot_file: str,
        img_dir: str,
        dataset: str,
        is_train: bool = False,
        img_res: int = 224,
        aug: Optional[AugmentationConfig] = None,
        occluders=None,
        ignore_3d: bool = False,
        use_gt_cam: bool = False,
        baseline_cam_rot: bool = False,
        baseline_cam_f: bool = False,
        baseline_cam_c: bool = False,
        normalize: bool = False,
        render_res: int = 480,
        emit_disp_img: bool = False,
        num_images: int = 0,
        seed: int = 0,
        fast_decode: bool = False,
        decode_cache: int = 0,
        native_decode='auto',
        region_cache_dir: str = '',
        region_cache_format: str = 'jpeg',
    ):
        for name, value in (('is_train=True', is_train),
                            ('occluders', occluders is not None),
                            ('fast_decode', fast_decode),
                            ('region_cache_dir', region_cache_dir)):
            if value:
                raise NotImplementedError(f'CamDataset {name} {_ITEM9}')
        self.dataset = dataset
        self.img_dir = img_dir
        self.is_train = False
        self.img_res = img_res
        self.aug = aug or AugmentationConfig()
        self.use_gt_cam = use_gt_cam
        self.baseline_cam_rot = baseline_cam_rot
        self.baseline_cam_f = baseline_cam_f
        self.baseline_cam_c = baseline_cam_c
        self.normalize = normalize
        self.render_res = render_res
        self.emit_disp_img = emit_disp_img
        self.native_decode = native_decode
        self._frame_cache = FrameCache(decode_cache) if decode_cache \
            else None

        data = np.load(annot_file, allow_pickle=True)
        self.files = set(data.files)
        self.imgname = data['imgname']
        if num_images > 0:
            n0 = len(self.imgname)
            sel = np.random.RandomState(seed).choice(
                n0, size=min(num_images, n0), replace=False)
            sub = {}
            for k in data.files:
                arr = np.asarray(data[k])
                sub[k] = arr[sel] if arr.ndim >= 1 and arr.shape[0] == n0 \
                    else arr
            data = _NpzView(sub)
            self.imgname = data['imgname']
        self.scale = data['scale'].astype(np.float32)
        self.center = data['center'].astype(np.float32)
        n = len(self.imgname)

        pose_key = ('pose_0yaw_inverseyz'
                    if 'pose_0yaw_inverseyz' in self.files else 'pose')
        if pose_key in self.files and 'shape' in self.files:
            self.pose = data[pose_key].astype(np.float32)
            self.betas = data['shape'].astype(np.float32)
            self.has_smpl = (data['has_smpl'].astype(np.float32)
                             if 'has_smpl' in self.files
                             else np.ones(n, np.float32))
        else:
            self.pose = np.zeros((n, 72), np.float32)
            self.betas = np.zeros((n, 10), np.float32)
            self.has_smpl = np.zeros(n, np.float32)
        if ignore_3d:
            self.has_smpl = np.zeros(n, np.float32)

        if 'S' in self.files and not ignore_3d:
            self.pose_3d = data['S'].astype(np.float32)
            self.has_pose_3d = 1
        else:
            self.pose_3d = None
            self.has_pose_3d = 0

        kp_gt = (data['part'].astype(np.float32) if 'part' in self.files
                 else np.zeros((n, 24, 3), np.float32))
        kp_op = (data['openpose'].astype(np.float32)
                 if 'openpose' in self.files
                 else np.zeros((n, 25, 3), np.float32))
        self.keypoints = np.concatenate([kp_op, kp_gt], axis=1)

        if 'gender' in self.files:
            self.gender = np.array(
                [0 if str(g) == 'm' else 1 for g in data['gender']],
                np.int32)
        else:
            self.gender = -np.ones(n, np.int32)

        for k in ('focal_length', 'cam_rotmat', 'cam_pitch', 'cam_roll',
                  'cam_ext', 'cam_int', 'camcalib_pitch', 'camcalib_roll',
                  'camcalib_vfov', 'camcalib_f_pix'):
            setattr(self, k, data[k] if k in self.files else None)
        self.pose_cam = (data['pose_cam'].astype(np.float32)
                         if 'pose_cam' in self.files else None)

    def __len__(self):
        return len(self.imgname)

    # -- camera assembly ------------------------------------------------

    def _gt_focal(self, index):
        """The reference's focal-length fallback chain."""
        if self.baseline_cam_f:
            return 5000.0, 5000.0
        if self.focal_length is not None:
            f = np.atleast_1d(np.asarray(self.focal_length[index],
                                         np.float64))
            return (float(f[0]), float(f[1])) if f.size > 1 else \
                (float(f[0]), float(f[0]))
        if self.dataset == 'h36m':
            return 1150.0, 1150.0
        if self.dataset == 'mpi-inf-3dhp':
            return 1500.0, 1500.0
        if self.cam_int is not None:
            K = self.cam_int[index]
            return float(K[0, 0]), float(K[1, 1])
        return 5000.0, 5000.0

    def _build_K(self, fx, fy, center, orig_shape):
        cx, cy = ((float(center[0]), float(center[1]))
                  if self.baseline_cam_c
                  else (orig_shape[1] / 2.0, orig_shape[0] / 2.0))
        K = np.zeros((3, 3), np.float32)
        K[0, 0], K[1, 1] = fx, fy
        K[0, 2], K[1, 2] = cx, cy
        K[2, 2] = 1.0    # a proper pinhole K; nothing reads [2, 2]
        return K

    def _pred_cam(self, index, center, orig_shape):
        """CamCalib's camera from the camcalib_* columns: (pitch, roll,
        vfov, f, rotmat, K); identity rotation and f = 5000 without
        them."""
        pitch = 0.0 if self.baseline_cam_rot else (
            float(self.camcalib_pitch[index])
            if self.camcalib_pitch is not None else 0.0)
        roll = 0.0 if self.baseline_cam_rot else (
            float(self.camcalib_roll[index])
            if self.camcalib_roll is not None else 0.0)
        f = 5000.0 if self.baseline_cam_f else (
            float(self.camcalib_f_pix[index])
            if self.camcalib_f_pix is not None else 5000.0)
        vfov = (float(self.camcalib_vfov[index])
                if self.camcalib_vfov is not None else 0.0)
        rotmat = euler_pitch_roll_np(pitch, roll)
        K = self._build_K(f, f, center, orig_shape)
        return pitch, roll, vfov, f, rotmat, K

    # -- item -----------------------------------------------------------

    def __getitem__(self, index: int) -> dict:
        item = {}
        scale = float(self.scale[index])
        center = self.center[index].copy()
        keypoints_orig = self.keypoints[index].copy()

        t0 = time.perf_counter()
        imgname = join(self.img_dir, str(self.imgname[index]))
        raw_crop, disp, orig_shape = self._crops(imgname, center, scale)
        load_time = time.perf_counter() - t0

        pose = (self.pose[index].copy() if self.has_smpl[index]
                else np.zeros(72, np.float32))
        betas = (self.betas[index].copy() if self.has_smpl[index]
                 else np.zeros(10, np.float32))
        keypoints = self._j2d(self.keypoints[index].copy(), center, scale)

        t1 = time.perf_counter()
        img = np.clip(raw_crop, 0, 255).astype(np.float32) / 255.0
        if self.normalize:
            from spec_tpu_torch.core import constants as C
            img = ((img - C.IMG_NORM_MEAN) / C.IMG_NORM_STD).astype(
                np.float32)
        proc_time = time.perf_counter() - t1

        item['img'] = img                    # HWC
        if self.emit_disp_img:
            item['disp_img'] = (disp / 255.0).astype(np.float32)
        item['pose'] = pose.astype(np.float32)
        item['betas'] = betas
        item['imgname'] = imgname
        item['pose_conf'] = np.ones(24, np.float32)
        in_the_wild = self.dataset in ('mpii', 'coco', 'lspet')
        if self.aug.use_3d_conf and in_the_wild:
            from spec_tpu_torch.core.kp_utils import map_spin_joints_to_smpl
            for srcs, dst in map_spin_joints_to_smpl():
                item['pose_conf'][dst] = max(
                    keypoints[25 + s_, 2] for s_ in srcs)

        if self.has_pose_3d:
            item['pose_3d'] = self.pose_3d[index].copy().astype(np.float32)
            if self.aug.use_3d_conf and in_the_wild:
                from spec_tpu_torch.core.kp_utils import (
                    relation_among_spin_joints,
                )
                for srcs, dst in relation_among_spin_joints():
                    conf = max([keypoints[x, 2] for x in srcs]
                               + [keypoints[dst, 2]])
                    item['pose_3d'][dst - 25, -1] = np.float32(conf)
        else:
            item['pose_3d'] = np.zeros((24, 4), np.float32)

        item['keypoints_orig'] = keypoints_orig.astype(np.float32)
        item['keypoints'] = keypoints
        item['has_smpl'] = np.float32(self.has_smpl[index])
        item['has_pose_3d'] = np.float32(self.has_pose_3d)
        item['scale'] = np.float32(scale)
        item['center'] = center.astype(np.float32)
        item['orig_shape'] = orig_shape
        item['is_flipped'] = np.float32(0)
        item['rot_angle'] = np.float32(0.0)
        item['gender'] = self.gender[index]
        item['sample_index'] = index
        item['dataset_name'] = self.dataset

        fx, fy = self._gt_focal(index)
        item['focal_length'] = np.array([fx, fy], np.float32)
        if self.cam_rotmat is not None and not self.baseline_cam_rot:
            item['cam_rotmat'] = self.cam_rotmat[index].astype(np.float32)
        else:
            item['cam_rotmat'] = np.eye(3, dtype=np.float32)
        item['cam_pitch'] = np.float32(
            self.cam_pitch[index] if self.cam_pitch is not None
            and not self.baseline_cam_rot else 0.0)
        item['cam_roll'] = np.float32(
            self.cam_roll[index] if self.cam_roll is not None
            and not self.baseline_cam_rot else 0.0)
        if self.cam_ext is not None:
            item['cam_ext'] = self.cam_ext[index].astype(np.float32)
        if self.cam_int is not None and not self.baseline_cam_f:
            item['cam_int'] = self.cam_int[index].astype(np.float32)
        else:
            item['cam_int'] = self._build_K(fx, fy, center, orig_shape)

        (item['pred_cam_pitch'], item['pred_cam_roll'],
         item['pred_cam_vfov'], item['pred_cam_focal_length'],
         item['pred_cam_rotmat'], item['pred_cam_int']) = \
            [np.float32(v) if np.isscalar(v) else v.astype(np.float32)
             for v in self._pred_cam(index, center, orig_shape)]

        item['load_time'] = np.float32(load_time)
        item['proc_time'] = np.float32(proc_time)
        return item

    # -- decode and crop ------------------------------------------------

    def _decode(self, imgname):
        img = T.read_img(imgname)
        return img, np.array(img.shape[:2], np.float32)

    def _crops(self, imgname, center, scale):
        """-> (model crop float32 [0, 255] HWC, render_res crop or None,
        orig_shape (H, W) float32)."""
        if self._frame_cache is not None:
            img, orig_shape = self._frame_cache.get_or_compute(
                (imgname, 1), lambda: self._decode(imgname))
        else:
            img, orig_shape = self._decode(imgname)
        crop = T.crop(img, center, scale, [self.img_res, self.img_res])
        disp = (T.crop(img, center, scale,
                       [self.render_res, self.render_res])
                if self.emit_disp_img else None)
        return crop, disp, orig_shape

    def _j2d(self, kp, center, scale):
        """2D keypoints into the crop, SPIN's way (1-based, truncated to
        int), then normalized to [-1, 1]."""
        t = T.get_transform(center, scale, [self.img_res, self.img_res])
        pts = np.concatenate([kp[:, :2], np.ones((kp.shape[0], 1))], axis=1)
        kp = kp.copy()
        kp[:, :2] = (t @ pts.T).T[:, :2].astype(int) + 1
        kp[:, :-1] = 2.0 * kp[:, :-1] / self.img_res - 1.0
        return kp.astype(np.float32)
