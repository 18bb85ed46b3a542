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

Decode and crop, per item, in this order (the reference's):
the per-sample region cache (``region_cache_dir``,
``data/region_cache.py``), the decoded-frame LRU (``decode_cache``),
the fused native JPEG region-of-interest decode (``csrc/jpegroi.cpp``:
only the crop's window is decoded), then cv2's full decode. The native
paths need the engine: ``native_decode`` 'auto' or True takes them
where it built (resolved at the first item; when it cannot build, a line
on stdout says so and why), False always takes cv2's path, the parity
oracle. Non-JPEG bytes, EXIF-rotated and progressive JPEGs go to cv2
per item. ``fast_decode`` decodes at 1/2, 1/4 or 1/8 scale where the
box is large enough to stay a downsample (``transforms.pick_reduce``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from os.path import join
from typing import Optional

import numpy as np

from spec_tpu_torch.core.geometry import euler_pitch_roll_np
from spec_tpu_torch.data import transforms as T
from spec_tpu_torch.data.cache import FrameCache
from spec_tpu_torch.data.occlusion import occlude_with_objects



@functools.cache
def _say_cv2_path(reason: str) -> None:
    print('[data] native JPEG engine unavailable (csrc/jpegroi.cpp did '
          f'not build: {reason}); CamDataset decodes with cv2')


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
    cutouts, ``seed`` the augmentation stream's), ``fast_decode`` (the
    reduced-scale decode), ``native_decode`` ('auto' / True: the native
    JPEG engine where it built; False: cv2), ``region_cache_dir`` and
    ``region_cache_format`` ('jpeg' or 'raw'; the region cache, scoped
    to a ``<dataset>_<train|val>`` subdirectory, as files are keyed by
    sample index).
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
        self.fast_decode = fast_decode
        self.native_decode = bool(native_decode)
        self._native = None        # resolved at the first item
        self._frame_cache = FrameCache(decode_cache) if decode_cache \
            else None
        self._region_cache = None
        if region_cache_dir:
            from spec_tpu_torch.data.region_cache import RegionCache

            self._region_cache = RegionCache(
                os.path.join(region_cache_dir,
                             f'{dataset}_{"train" if is_train else "val"}'),
                fmt=region_cache_format)
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
            index, imgname, center, sc * scale, rot, want_disp)
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

    def _native_ok(self) -> bool:
        """Whether the native JPEG engine serves this dataset, resolved
        at the first item (constructing a dataset builds nothing)."""
        if self._native is None:
            if not self.native_decode:
                self._native = False
            else:
                from spec_tpu_torch import native

                self._native, reason = native.jpeg_engine()
                if not self._native:
                    _say_cv2_path(reason)
        return self._native

    def _reduce_for(self, scale) -> int:
        """The ``fast_decode`` reduction: the largest that keeps the
        img_res crop (and the eval path's render_res display crop) a
        downsample; 1 without ``fast_decode``. Keypoints, K and
        orig_shape stay in full-resolution coordinates."""
        if not self.fast_decode:
            return 1
        need = self.img_res
        if not self.is_train and self.emit_disp_img:
            need = max(need, self.render_res)
        return T.pick_reduce(T.BBOX_SIDE * scale, need)

    def _decode(self, imgname, reduce):
        if reduce > 1:
            # the header's full-resolution dims; pixels decode reduced
            return (T.read_img(imgname, reduce=reduce),
                    T.image_dims(imgname))
        img = T.read_img(imgname)
        return img, np.array(img.shape[:2], np.float32)

    def _plans(self, center, scale, rot, want_disp, reduce):
        """The native sampler's crop plans: the model crop and, with
        ``want_disp``, the display crop. The SPIN clamp box applies where
        the cv2 path is the slice and resize of ``transforms.crop``
        (rot == 0 at full resolution); reduced or rotated crops are
        zero-bordered affine warps (``transforms.crop_from_reduced``)."""
        res = [self.img_res, self.img_res]
        aff, box = T.crop_affine(center, scale, res, rot)
        clamp = rot == 0 and reduce == 1
        plans = [(res, aff, box if clamp else None)]
        if want_disp:
            dres = [self.render_res, self.render_res]
            aff2, box2 = T.crop_affine(center, scale, dres, rot)
            plans.append((dres, aff2, box2 if clamp else None))
        return plans

    def _crops(self, index, imgname, center, scale, rot, want_disp):
        """-> (model crop float32 [0, 255] HWC, render_res crop or None,
        orig_shape (H, W) float32). Path priority: the region cache, the
        decoded-frame LRU, the fused native ROI decode, cv2; each native
        step falls back to cv2's per item (non-JPEG bytes, EXIF-rotated
        or progressive files, decode errors)."""
        native_ok = self._native_ok()

        if self._region_cache is not None and native_ok:
            out = self._region_crops(index, imgname, center, scale, rot,
                                     want_disp)
            if out is not None:
                return out

        reduce = self._reduce_for(scale)

        if self._frame_cache is not None:
            img, orig_shape = self._frame_cache.get_or_compute(
                (imgname, reduce), lambda: self._decode(imgname, reduce))
            crop, disp = self._crops_from_frame(
                img, center, scale, rot, want_disp, reduce, native_ok)
            return crop, disp, orig_shape

        if native_ok:
            out = self._fused_crops(imgname, center, scale, rot, want_disp,
                                    reduce)
            if out is not None:
                return out

        img, orig_shape = self._decode(imgname, reduce)
        crop, disp = self._crops_from_frame(
            img, center, scale, rot, want_disp, reduce, native_ok)
        return crop, disp, orig_shape

    def _crops_from_frame(self, img, center, scale, rot, want_disp, reduce,
                          native_ok):
        """Crop(s) from a decoded frame: the native sampler with the
        engine (no full-frame float32 copy), cv2 otherwise."""
        if native_ok and img.dtype == np.uint8:
            from spec_tpu_torch import native

            crops = [native.crop_affine_u8(img, aff, res, box=box,
                                           reduce=reduce)
                     for res, aff, box in self._plans(
                         center, scale, rot, want_disp, reduce)]
        else:
            crops = [T.crop_from_reduced(
                img, center, scale, [self.img_res, self.img_res], reduce,
                rot=rot)]
            if want_disp:
                crops.append(T.crop_from_reduced(
                    img, center, scale, [self.render_res, self.render_res],
                    reduce, rot=rot))
        return crops[0], (crops[1] if want_disp else None)

    @staticmethod
    def _jpeg_probe(data):
        """(H, W) of a baseline JPEG without EXIF rotation, else None
        (such files take the cv2 path)."""
        from spec_tpu_torch import native

        if data.size < 2 or data[0] != 0xFF or data[1] != 0xD8:
            return None                       # not a JPEG
        probe = native.jpeg_probe(data)
        # EXIF-rotated (cv2 applies the rotation) or progressive (the
        # partial decode rejects it only after a full entropy pass)
        if probe is None or probe[2] != 1 or probe[3]:
            return None
        return probe[0], probe[1]

    def _fused_crops(self, imgname, center, scale, rot, want_disp, reduce):
        """Decode only the crop's window and sample the crop(s) natively,
        no frame in Python. None: the caller takes the cv2 path."""
        try:
            data = np.fromfile(imgname, np.uint8)
        except OSError:
            raise FileNotFoundError(imgname)
        hw = self._jpeg_probe(data)
        if hw is None:
            return None
        plans = self._plans(center, scale, rot, want_disp, reduce)
        crops = T.native_jpeg_crops(data, plans, hw, reduce=reduce)
        if crops is None:
            return None
        return crops[0], (crops[1] if want_disp else None), \
            np.array(hw, np.float32)

    # -- region cache ---------------------------------------------------

    def _region_window(self, index):
        """The sample's decode window in full-resolution coordinates
        (u0, v0, u1, v1) and its grid's reduction: it covers every crop
        the sample can request under the augmentation bounds (the largest
        scale jitter; random sub-crops stay inside the box; a rotated
        box's bounding square, side * sqrt(2))."""
        center = self.center[index]
        scale = float(self.scale[index])
        sf = self.aug.scale_factor if self.is_train else 0.0
        need = self.img_res
        if not self.is_train and self.emit_disp_img:
            need = max(need, self.render_res)
        r = 1
        if self.fast_decode:
            # the finest grid any draw needs: the smallest box, after the
            # scale jitter and a random sub-crop, or a 224 crop would be
            # upsampled from a too-coarse grid
            cf = (self.aug.crop_factor
                  if self.is_train and self.aug.crop_prob > 0 else 0.0)
            r = T.pick_reduce(
                T.BBOX_SIDE * max(scale * (1 - sf) * (1 - cf), 1e-3), need)
        side = T.BBOX_SIDE * scale * (1 + sf)
        if self.is_train and self.aug.rot_factor > 0:
            side *= np.sqrt(2.0)
        half = side / 2.0 + 4.0   # corner truncation and bilinear slack
        return (float(center[0]) - half, float(center[1]) - half,
                float(center[0]) + half, float(center[1]) + half), r

    @staticmethod
    def _clamped_window(u0, v0, u1, v1, r, rh, rw):
        off = (r - 1) / 2.0
        x0 = max(0, int(np.floor((u0 - off) / r)) - 2)
        y0 = max(0, int(np.floor((v0 - off) / r)) - 2)
        x1 = min(rw, int(np.ceil((u1 - off) / r)) + 3)
        y1 = min(rh, int(np.ceil((v1 - off) / r)) + 3)
        return x0, y0, x1, y1

    def _fill_region(self, index, imgname):
        """Decode the sample's window (natively for a baseline JPEG, by
        cv2 otherwise) and store it; -> (region, meta) or None."""
        from spec_tpu_torch import native

        (u0, v0, u1, v1), r = self._region_window(index)
        try:
            data = np.fromfile(imgname, np.uint8)
        except OSError:
            raise FileNotFoundError(imgname)
        hw = self._jpeg_probe(data)
        if hw is not None:
            H, W = hw
            x0, y0, x1, y1 = self._clamped_window(
                u0, v0, u1, v1, r, -(-H // r), -(-W // r))
            if x1 <= x0 or y1 <= y0:
                return None                    # the box is off the frame
            got = native.jpeg_decode_roi(data, x0, y0, x1 - x0, y1 - y0,
                                         reduce=r)
            if got is None:
                return None
            region = got[0]
        else:
            img, dims = self._decode(imgname, r)
            H, W = int(dims[0]), int(dims[1])
            x0, y0, x1, y1 = self._clamped_window(
                u0, v0, u1, v1, r, img.shape[0], img.shape[1])
            if x1 <= x0 or y1 <= y0 or img.dtype != np.uint8:
                return None
            region = np.ascontiguousarray(img[y0:y1, x0:x1])
        self._region_cache.put(index, region, x0, y0, r, (H, W))
        return region, {'x0': x0, 'y0': y0, 'reduce': r, 'full_hw': (H, W)}

    @staticmethod
    def _region_covers(region, meta, plans, r):
        """Whether the region holds every bilinear tap of every plan. A
        region filled under smaller augmentation bounds does not; it
        would zero-pad the crop's borders, so it is refilled instead."""
        H, W = meta['full_hw']
        for res, aff, box in plans:
            win = T.sample_window(aff, box, res, (H, W), r)
            if win is None:
                continue    # the crop misses the frame: zeros either way
            x0, y0, w, h = win
            if (x0 < meta['x0'] or y0 < meta['y0']
                    or x0 + w > meta['x0'] + region.shape[1]
                    or y0 + h > meta['y0'] + region.shape[0]):
                return False
        return True

    def _region_crops(self, index, imgname, center, scale, rot,
                      want_disp):
        from spec_tpu_torch import native

        got = self._region_cache.get(index)
        fresh = got is None
        if fresh:
            got = self._fill_region(index, imgname)
        if got is None:
            return None
        region, meta = got
        r = meta['reduce']
        plans = self._plans(center, scale, rot, want_disp, r)
        # A region written under older augmentation bounds is stale when
        # it misses a tap, or when its grid is coarser than the current
        # bounds need (the crop would be upsampled): refill it.
        stale_grid = r > self._region_window(index)[1]
        if stale_grid or not self._region_covers(region, meta, plans, r):
            if fresh:
                return None       # the window cannot cover it: cv2 path
            got = self._fill_region(index, imgname)
            if got is None:
                return None
            region, meta = got
            r = meta['reduce']
            plans = self._plans(center, scale, rot, want_disp, r)
            if not self._region_covers(region, meta, plans, r):
                return None
        origin = (meta['x0'], meta['y0'])
        crops = [native.crop_affine_u8(region, aff, res, box=box, reduce=r,
                                       origin=origin)
                 for res, aff, box in plans]
        return crops[0], (crops[1] if want_disp else None), \
            np.array(meta['full_hw'], np.float32)

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
