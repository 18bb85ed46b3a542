"""Camera-annotated person-crop dataset (port of
``spec_tpu/data/cam_dataset.py``).

A struct-of-arrays annotation store over one npz and a host
``__getitem__`` that decodes and crops; the GT SMPL forwards, the
ImageNet normalization and the metrics or losses run in the batched eval
and train steps on the device (``eval/eval_loop.py``,
``train/steps.py``). With ``is_train`` the item is augmented as the
reference's: scale jitter, optional rotation and flip, random sub-crops,
synthetic occluders, motion blur and per-channel pixel noise, drawn from
the dataset's ``RandomState(seed)`` in the reference's order.

npz contract: imgname, scale, center; pose or pose_0yaw_inverseyz (the
yaw-normalized world pose, preferred), shape, has_smpl; S (24 x 4 3D
joints); part (24 x 3) and openpose (25 x 3) 2D keypoints; gender
('m' / 'f'); focal_length, cam_rotmat, cam_pitch, cam_roll, cam_ext,
cam_int (the GT camera); camcalib_{pitch,roll,vfov,f_pix} (CamCalib's
predictions); pose_cam (camera-frame GT pose, for the offline metrics).

Decoding is cv2's: the reference's ``native_decode=False`` path, which is
its parity oracle. Its native JPEG region-of-interest engine
(``spec_tpu/native``) has no counterpart in the port, so
``native_decode`` selects this one path whatever its value.
``fast_decode`` (the reduced-scale decode) and ``region_cache_dir`` (the
per-sample region cache) are not ported yet (ROADMAP.md §1 item 9, with
``data/region_cache.py``) and raise.
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
from spec_tpu_torch.data.occlusion import occlude_with_objects

_ITEM9 = ('is not ported yet (ROADMAP.md §1 item 9: data/region_cache.py '
          'and fast_decode)')


@dataclasses.dataclass
class AugmentationConfig:
    """The reference's augmentation settings (its training defaults).
    Eval mode applies none of them; ``use_3d_conf`` copies 2D keypoint
    confidences onto the pose and 3D joints of in-the-wild datasets in
    either mode, and occluders, when given, are pasted in either."""

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
    """Map-style dataset over one annotation npz.

    Args: those of ``spec_tpu.data.CamDataset``. ``annot_file`` (npz),
    ``img_dir`` (the root of its imgnames), ``dataset`` (the name tag:
    '3dpw-test-cam', 'spec-syn', ...), ``img_res`` (224), ``normalize``
    (ImageNet-normalize on the host; the eval step normalizes on the
    device), ``baseline_cam_rot`` / ``_f`` / ``_c`` (the
    DATASET.BASELINE_CAM_* ablations), ``render_res`` and
    ``emit_disp_img`` (a second, render_res crop per item),
    ``num_images`` (a seeded subsample without replacement),
    ``decode_cache`` (a decoded-frame LRU of that many frames),
    ``is_train`` (augment: ``aug``, ``occluders`` a list of RGBA
    cutouts, ``seed`` the augmentation stream's).
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
        for name, value in (('fast_decode', fast_decode),
                            ('region_cache_dir', region_cache_dir)):
            if value:
                raise NotImplementedError(f'CamDataset {name} {_ITEM9}')
        self.dataset = dataset
        self.img_dir = img_dir
        self.is_train = is_train
        self.img_res = img_res
        self.aug = aug or AugmentationConfig()
        self.occluders = occluders
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
        self.rng = np.random.RandomState(seed)

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

        flip, pn, rot, sc = self._augm_params()
        if self.is_train and self.aug.crop_factor > 0 \
                and self.rng.rand() < self.aug.crop_prob:
            center, scale = T.random_crop(
                center, scale, 1 - self.aug.crop_factor, axis='y',
                rng=self.rng)

        t0 = time.perf_counter()
        imgname = join(self.img_dir, str(self.imgname[index]))
        want_disp = not self.is_train and self.emit_disp_img
        raw_crop, disp, orig_shape = self._crops(
            imgname, center, sc * scale, rot, want_disp)
        load_time = time.perf_counter() - t0

        pose = (self.pose[index].copy() if self.has_smpl[index]
                else np.zeros(72, np.float32))
        betas = (self.betas[index].copy() if self.has_smpl[index]
                 else np.zeros(10, np.float32))
        keypoints = self._j2d(self.keypoints[index].copy(), center,
                              sc * scale, rot, flip)

        t1 = time.perf_counter()
        img = self._rgb(raw_crop, flip, pn, keypoints)
        proc_time = time.perf_counter() - t1

        item['img'] = img                    # HWC
        if want_disp:
            item['disp_img'] = (disp / 255.0).astype(np.float32)
        item['pose'] = self._pose(pose, rot, flip)
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
            S = self.pose_3d[index].copy()
            if (self.cam_rotmat is not None and self.baseline_cam_rot
                    and self.is_train):
                S[:, :3] = (self.cam_rotmat[index] @ S[:, :3].T).T
            item['pose_3d'] = self._j3d(S, rot, flip)
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
        item['scale'] = np.float32(sc * scale)
        item['center'] = center.astype(np.float32)
        item['orig_shape'] = orig_shape
        item['is_flipped'] = np.float32(flip)
        item['rot_angle'] = np.float32(rot)
        item['gender'] = self.gender[index]
        item['sample_index'] = index
        item['dataset_name'] = self.dataset

        # The GT camera: the teacher in training, eval with USE_GT_CAM.
        fx, fy = self._gt_focal(index)
        item['focal_length'] = np.array([fx, fy], np.float32)
        if self.cam_rotmat is not None and not self.baseline_cam_rot:
            item['cam_rotmat'] = self.cam_rotmat[index].astype(np.float32)
        else:
            item['cam_rotmat'] = np.eye(3, dtype=np.float32)
            if (self.cam_rotmat is not None and self.baseline_cam_rot
                    and self.is_train):
                item['pose'][:3] = _rotate_global_aa(
                    self.cam_rotmat[index], item['pose'][:3])
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

        if not self.is_train:
            (item['pred_cam_pitch'], item['pred_cam_roll'],
             item['pred_cam_vfov'], item['pred_cam_focal_length'],
             item['pred_cam_rotmat'], item['pred_cam_int']) = \
                [np.float32(v) if np.isscalar(v) else v.astype(np.float32)
                 for v in self._pred_cam(index, center, orig_shape)]

        item['load_time'] = np.float32(load_time)
        item['proc_time'] = np.float32(proc_time)
        return item

    # -- augmentation ---------------------------------------------------

    def _augm_params(self):
        """(flip, per-channel pixel noise, rotation in degrees, scale
        factor): the reference's ``augm_params``, identity in eval."""
        flip, pn, rot, sc = 0, np.ones(3), 0.0, 1.0
        if self.is_train:
            a = self.aug
            if self.rng.uniform() <= a.flip_prob:
                flip = 1
            pn = self.rng.uniform(1 - a.noise_factor, 1 + a.noise_factor, 3)
            rot = float(np.clip(self.rng.randn() * a.rot_factor,
                                -2 * a.rot_factor, 2 * a.rot_factor))
            sc = float(np.clip(self.rng.randn() * a.scale_factor + 1,
                               1 - a.scale_factor, 1 + a.scale_factor))
            if self.rng.uniform() <= 0.6:
                rot = 0.0
        return flip, pn, rot, sc

    # -- decode and crop ------------------------------------------------

    def _decode(self, imgname):
        img = T.read_img(imgname)
        return img, np.array(img.shape[:2], np.float32)

    def _crops(self, imgname, center, scale, rot, want_disp):
        """-> (model crop float32 [0, 255] HWC, render_res crop or None,
        orig_shape (H, W) float32)."""
        if self._frame_cache is not None:
            img, orig_shape = self._frame_cache.get_or_compute(
                (imgname, 1), lambda: self._decode(imgname))
        else:
            img, orig_shape = self._decode(imgname)
        crop = T.crop(img, center, scale, [self.img_res, self.img_res],
                      rot=rot)
        disp = (T.crop(img, center, scale,
                       [self.render_res, self.render_res], rot=rot)
                if want_disp else None)
        return crop, disp, orig_shape

    def _rgb(self, out, flip, pn, kp2d):
        """Flip, occluders, motion blur (training), pixel noise, then
        [0, 1] float32 (ImageNet-normalized with ``normalize``)."""
        if flip:
            out = T.flip_img(out)
        if self.occluders is not None and self.aug.use_occlusion:
            out = occlude_with_objects(out, self.occluders, rng=self.rng,
                                       kp2d=kp2d, img_size=self.img_res)
        if self.is_train and self.aug.use_motion_blur:
            out = T.motion_blur(out, self.rng)
        out = np.clip(out * pn[None, None, :], 0, 255)
        out = out.astype(np.float32) / 255.0
        if self.normalize:
            from spec_tpu_torch.core import constants as C
            out = ((out - C.IMG_NORM_MEAN) / C.IMG_NORM_STD).astype(
                np.float32)
        return out

    def _j2d(self, kp, center, scale, rot=0.0, flip=0):
        """2D keypoints into the crop, SPIN's way (1-based, truncated to
        int), normalized to [-1, 1], flipped with the image."""
        t = T.get_transform(center, scale, [self.img_res, self.img_res],
                            rot=rot)
        pts = np.concatenate([kp[:, :2], np.ones((kp.shape[0], 1))], axis=1)
        kp = kp.copy()
        kp[:, :2] = (t @ pts.T).T[:, :2].astype(int) + 1
        kp[:, :-1] = 2.0 * kp[:, :-1] / self.img_res - 1.0
        if flip:
            kp = T.flip_kp(kp)
        return kp.astype(np.float32)

    def _j3d(self, S, rot, flip):
        """3D joints rotated in-plane with the crop and flipped."""
        if rot != 0:
            rot_rad = -rot * np.pi / 180
            sn, cs = np.sin(rot_rad), np.cos(rot_rad)
            R = np.eye(3)
            R[0, :2] = [cs, -sn]
            R[1, :2] = [sn, cs]
            S[:, :3] = np.einsum('ij,kj->ki', R, S[:, :3])
        if flip:
            S = T.flip_kp(S)
        return S.astype(np.float32)

    def _pose(self, pose, rot, flip):
        """The global orientation rotated with the crop; the pose
        flipped with the image."""
        pose = pose.copy()
        pose[:3] = T.rot_aa(pose[:3], rot)
        if flip:
            pose = T.flip_pose(pose)
        return pose.astype(np.float32)


def _rotate_global_aa(rotmat, aa):
    """The global orientation ``aa`` rotated by ``rotmat`` (the
    BASELINE_CAM_ROT ablation's training pose)."""
    import cv2

    R0, _ = cv2.Rodrigues(aa.astype(np.float64))
    out, _ = cv2.Rodrigues(rotmat.astype(np.float64) @ R0)
    return out.reshape(3).astype(np.float32)
