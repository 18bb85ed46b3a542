"""Synthetic rendered SPEC dataset: the full annotation contract with
self-consistent GT, from the in-repo rasterizer.

Purpose: end-to-end *accuracy* evidence for the SPEC training stack in a
sandbox without the released checkpoints or mocap datasets. Bodies are a
deterministic HUMANOID synthetic SMPL (``make_humanoid_smpl_raw``: tube
limbs over the real kinematic tree, localized joint regressors and
skinning — random test-asset regressors collapse all joints onto the
centroid, making MPJPE blind to pose), installed into the data root
through the REAL release file formats (chumpy-dialect pkl + regressor
npys) so ``spec_train``/``spec_eval`` load the SAME body through the
production loader that generated the GT. Samples vary global
orientation + a low-dim articulated subspace, are rendered with
``utils.renderer.rasterize_mesh`` (native C++ z-buffer), and annotated
with exactly the npz columns the real datasets carry (reference
``spec/dataset/cam_dataset.py:61-115``):

  imgname, scale, center, pose_cam, pose_0yaw_inverseyz, shape,
  S (24x4 3D joints+conf), part (24x3 2D joints+conf),
  openpose (25x3, conf 0), cam_int, cam_rotmat,
  camcalib_{vfov,pitch,roll,f_pix}

Every label is derived through the SAME functions the model/losses use
(``smpl_forward`` joint_set='spin49', ``geometry.perspective_projection``),
so the supervision is exactly consistent: a model that learns the
image -> pose mapping drives MPJPE to the rendering floor. The camera is
identity-rotation (pitch = roll = 0) so the world and camera pose
columns coincide and stage-1 conditioning is constant.

No reference analogue: the reference's eval table (README.md:153-159)
relies on released checkpoints + mocap GT; this is the in-sandbox stand-in
that proves the same train->eval product path learns.

Port of ``spec_tpu/datagen/spec_synth.py``: the same draws in the same
order. SMPL runs through the port's ``smpl_forward`` with K1's packed
operands on ``device``: on a card, ONE launch of the fused LBS kernel
over all ``n`` samples. Frames come from ``csrc/raster.cpp``; the JPEG
writer is injectable (the default is cv2's, imported when it runs), so
a machine without cv2 can run the whole body and keep frames in memory.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional

import numpy as np

from spec_tpu_torch.core import constants as C


# Rest-pose joint table (camera-ish frame: y DOWN so heads render
# upright under the pinhole projection, z forward). Rough SMPL
# proportions; exact values are irrelevant — only that joints are
# geometrically DISTINCT (create_test_assets' random row-stochastic
# regressors collapse every joint onto the centroid, which makes MPJPE
# blind to pose — measured: 6 mm at random init).
_REST_JOINTS = np.array([
    [0.00, 0.00, 0.0],     # 0 pelvis
    [0.09, 0.06, 0.0],     # 1 L hip
    [-0.09, 0.06, 0.0],    # 2 R hip
    [0.00, -0.11, 0.0],    # 3 spine1
    [0.10, 0.45, 0.0],     # 4 L knee
    [-0.10, 0.45, 0.0],    # 5 R knee
    [0.00, -0.22, 0.0],    # 6 spine2
    [0.11, 0.85, 0.0],     # 7 L ankle
    [-0.11, 0.85, 0.0],    # 8 R ankle
    [0.00, -0.32, 0.0],    # 9 spine3
    [0.13, 0.92, -0.10],   # 10 L foot
    [-0.13, 0.92, -0.10],  # 11 R foot
    [0.00, -0.50, 0.0],    # 12 neck
    [0.07, -0.44, 0.0],    # 13 L collar
    [-0.07, -0.44, 0.0],   # 14 R collar
    [0.00, -0.64, 0.0],    # 15 head
    [0.19, -0.44, 0.0],    # 16 L shoulder
    [-0.19, -0.44, 0.0],   # 17 R shoulder
    [0.44, -0.42, 0.0],    # 18 L elbow
    [-0.44, -0.42, 0.0],   # 19 R elbow
    [0.68, -0.40, 0.0],    # 20 L wrist
    [-0.68, -0.40, 0.0],   # 21 R wrist
    [0.76, -0.40, 0.0],    # 22 L hand
    [-0.76, -0.40, 0.0],   # 23 R hand
], np.float64)

_BONE_RADIUS = np.array([
    0.10, 0.09, 0.05, 0.10, 0.075, 0.040, 0.10, 0.060, 0.032, 0.09,
    0.055, 0.028, 0.055, 0.07, 0.045, 0.11, 0.065, 0.038, 0.055,
    0.030, 0.048, 0.025, 0.042, 0.022], np.float64)
# radius at each CHILD joint. Deliberately LEFT/RIGHT ASYMMETRIC
# (left limbs ~1.7x thicker): a mirror-symmetric tube body makes +yaw
# and -yaw silhouettes nearly identical, and the resulting yaw-sign
# ambiguity floors MPJPE (measured: PA-MPJPE 1.85x improvement while
# MPJPE stalled at 1.26x). The thickness cue disambiguates.


def make_humanoid_smpl_raw(num_vertices: int = C.NUM_SMPL_VERTICES,
                           seed: int = 0, num_betas: int = 10):
    """Structured synthetic SMPL raw arrays (the real pkl's layouts):
    each bone is a vertex tube between its rest joints, skinning weights
    interpolate parent->child along the tube, and every regressor
    (native 24, extra 9, h36m 17) is a LOCALIZED gaussian around its
    joint — so regressed joints track the limbs and MPJPE actually
    measures pose error. Returns (raw dict for
    :func:`write_smpl_pkl`, jre (9, V), jrh (17, V)).
    """
    rng = np.random.RandomState(seed)
    J = C.NUM_SMPL_JOINTS
    parents = np.asarray(C.SMPL_PARENTS)
    NS = 5                                    # verts per tube ring
    assert num_vertices % NS == 0, 'tube layout needs V % 5 == 0'

    # Allocate rings per bone proportional to bone length.
    bones = [(int(parents[j]), j) for j in range(1, J)]
    lens = np.array([np.linalg.norm(_REST_JOINTS[c] - _REST_JOINTS[p])
                     for p, c in bones])
    total_rings = num_vertices // NS
    rings = np.maximum(2, (lens / lens.sum() * total_rings).astype(int))
    while rings.sum() > total_rings:
        rings[int(np.argmax(rings))] -= 1
    while rings.sum() < total_rings:
        rings[int(np.argmin(rings))] += 1

    verts = np.zeros((num_vertices, 3))
    weights = np.zeros((num_vertices, J))
    faces = []
    v0 = 0
    for bi, (p, c) in enumerate(bones):
        nr = int(rings[bi])
        a, b = _REST_JOINTS[p], _REST_JOINTS[c]
        axis = b - a
        ln = np.linalg.norm(axis)
        axis = axis / max(ln, 1e-9)
        # orthonormal frame perpendicular to the bone
        ref = np.array([0.0, 0.0, 1.0]) if abs(axis[2]) < 0.9 \
            else np.array([1.0, 0.0, 0.0])
        u = np.cross(axis, ref)
        u /= np.linalg.norm(u)
        w = np.cross(axis, u)
        r = _BONE_RADIUS[c]
        t = np.linspace(0.0, 1.0, nr)
        th = np.arange(NS) * (2 * np.pi / NS)
        for i in range(nr):
            ctr = a + t[i] * (b - a)
            for k in range(NS):
                vid = v0 + i * NS + k
                rr = r * (1.0 + 0.08 * rng.randn())
                verts[vid] = (ctr + rr * np.cos(th[k]) * u
                              + rr * np.sin(th[k]) * w)
                weights[vid, p] = 1.0 - t[i]
                weights[vid, c] = t[i]
        for i in range(nr - 1):
            for k in range(NS):
                q00 = v0 + i * NS + k
                q01 = v0 + i * NS + (k + 1) % NS
                q10 = q00 + NS
                q11 = q01 + NS
                faces.append([q00, q01, q10])
                faces.append([q01, q11, q10])
        v0 += nr * NS

    def _gauss_regressor(targets, sigma=0.06):
        d2 = ((verts[None, :, :] - targets[:, None, :]) ** 2).sum(-1)
        g = np.exp(-d2 / (2 * sigma * sigma)) + 1e-12
        return g / g.sum(axis=1, keepdims=True)

    j_reg = _gauss_regressor(_REST_JOINTS, sigma=0.05)
    # extra-9 around the head/face, h36m-17 mapped onto body joints
    head = _REST_JOINTS[15]
    extra_t = head[None] + rng.randn(9, 3) * 0.03
    jre = _gauss_regressor(extra_t, sigma=0.05)
    h36m_map = [0, 2, 5, 8, 1, 4, 7, 3, 9, 12, 15, 16, 18, 20, 17,
                19, 21]
    jrh = _gauss_regressor(_REST_JOINTS[np.array(h36m_map)], sigma=0.05)

    shapedirs = rng.randn(num_vertices, 3, num_betas) * 0.005
    shapedirs[:, :, 0] = verts * 0.1          # beta0 = global scale
    raw = {
        'v_template': verts,
        'shapedirs': shapedirs,
        'posedirs': np.zeros((num_vertices, 3, (J - 1) * 9)),
        'J_regressor': j_reg,
        'weights': weights,
        'kintree_table': np.stack([
            parents.astype(np.int64), np.arange(J)]).astype(np.uint32),
        'f': np.asarray(faces, np.uint32),
    }
    return raw, jre.astype(np.float32), jrh.astype(np.float32)


def write_smpl_pkl(path: str, raw: dict) -> None:
    """Write ``raw`` (the release pkl's arrays) as a chumpy-format SMPL
    .pkl without chumpy installed: a throwaway ``chumpy.ch.Ch`` class is
    registered in ``sys.modules`` just long enough to pickle, so the
    file's records name the real chumpy module, as the released
    ``SMPL_*.pkl`` files do. Skinning weights and the joint regressor's
    rows are normalized to sum 1; the regressor is stored as a sparse
    CSC matrix."""
    import pickle
    import sys
    import types

    import scipy.sparse

    w = raw['weights'] / raw['weights'].sum(axis=1, keepdims=True)
    jr = raw['J_regressor'] / raw['J_regressor'].sum(axis=1, keepdims=True)

    ch_mod = types.ModuleType('chumpy')
    ch_sub = types.ModuleType('chumpy.ch')

    class Ch:  # a minimal stand-in for chumpy.Ch
        def __init__(self, x):
            self.x = x

    Ch.__module__ = 'chumpy.ch'
    Ch.__qualname__ = 'Ch'
    ch_sub.Ch = Ch
    ch_mod.ch = ch_sub
    ch_mod.Ch = Ch
    sys.modules['chumpy'] = ch_mod
    sys.modules['chumpy.ch'] = ch_sub
    try:
        data = {
            'v_template': Ch(raw['v_template']),
            'shapedirs': Ch(raw['shapedirs']),
            'posedirs': raw['posedirs'],
            'J_regressor': scipy.sparse.csc_matrix(jr),
            'weights': Ch(w),
            'kintree_table': raw['kintree_table'],
            'f': raw['f'],
            'bs_style': 'lbs',
        }
        with open(path, 'wb') as f:
            pickle.dump(data, f, protocol=2)
    finally:
        del sys.modules['chumpy'], sys.modules['chumpy.ch']


def install_humanoid_smpl_assets(data_root: str, seed: int = 0) -> str:
    """Write the humanoid synthetic body into ``data_root`` through the
    REAL release file formats — chumpy-dialect ``SMPL_NEUTRAL.pkl`` +
    ``J_regressor_extra.npy``/``J_regressor_h36m.npy`` — so
    ``spec_train``/``spec_eval`` load it via the production SMPL loader
    rather than the test-assets fallback. Returns the smpl model dir.
    Idempotent."""
    smpl_dir = join(data_root, 'body_models', 'smpl')
    pkl = join(smpl_dir, 'SMPL_NEUTRAL.pkl')
    if os.path.exists(pkl):
        return smpl_dir
    os.makedirs(smpl_dir, exist_ok=True)
    raw, jre, jrh = make_humanoid_smpl_raw(seed=seed)
    # the pkl is the idempotence sentinel, so write it LAST — a partial
    # install (killed between writes) must not short-circuit the retry
    np.save(join(data_root, 'J_regressor_extra.npy'), jre)
    np.save(join(data_root, 'J_regressor_h36m.npy'), jrh)
    write_smpl_pkl(pkl, raw)
    return smpl_dir


def cv2_jpeg_writer(frame_u8: np.ndarray, path: str, quality: int) -> None:
    """The default frame writer: an RGB uint8 frame as a JPEG (cv2)."""
    import cv2

    cv2.imwrite(path, cv2.cvtColor(frame_u8, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, quality])


def render_spec_synth_dataset(
    data_root: str,
    dataset: str = 'spec-syn',
    n: int = 64,
    seed: int = 0,
    hw=(256, 320),
    f_pix: float = 400.0,
    orient_range=(0.9, 0.4, 0.2),
    body_pose_std: float = 0.03,
    articulation: float = 0.9,
    betas_std: float = 0.3,
    jpeg_quality: int = 95,
    device='cuda',
    writer=None,
    timings: Optional[dict] = None,
) -> str:
    """Render ``n`` samples into the SPEC_DATA_ROOT layout for
    ``dataset`` (one of the registry names, utils/paths.py) and write its
    annotation npz. Returns the npz path.

    ``orient_range``: half-ranges of the uniform global-orient
    axis-angle components (ay=yaw-ish, ax, az) — the global-rotation
    signal (drives MPJPE). ``articulation``: half-range of uniform
    z-axis rotations at shoulders/elbows/knees — a LOW-dimensional,
    image-plane-visible articulated subspace (drives PA-MPJPE; a
    full-69-dim pose distribution is not coverable by a small rendered
    train set, so held-out articulation would not be learnable).
    ``body_pose_std`` adds tiny full-dim nuisance jitter on top.

    ``device``: where SMPL and the projection run (one batch of ``n``).
    ``writer(frame_u8, path, jpeg_quality)`` writes each RGB frame
    (default :func:`cv2_jpeg_writer`). ``timings``, when given, receives
    ``smpl_s`` (the forward and projection, synchronized) and
    ``render_s`` (rasterizing and writing every frame).
    """
    import time

    import torch

    from spec_tpu_torch.core.geometry import perspective_projection
    from spec_tpu_torch.core.smpl import (
        load_smpl_assets,
        smpl_forward,
        with_packed_lbs,
    )
    from spec_tpu_torch.utils.renderer import rasterize_mesh

    writer = writer or cv2_jpeg_writer
    device = torch.device(device)
    rng = np.random.RandomState(seed)
    H, W = int(hw[0]), int(hw[1])
    name_map = {'spec-syn': 'spec-syn', 'spec-mtp': 'spec-mtp',
                '3dpw-test-cam': '3dpw', '3dpw': '3dpw'}
    img_dir = join(data_root, 'dataset_folders', name_map[dataset])
    extras = join(data_root, 'dataset_extras')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(extras, exist_ok=True)

    # The humanoid body through the REAL release-format loader — the
    # same files spec_train/spec_eval will resolve from this data_root.
    smpl_dir = install_humanoid_smpl_assets(data_root)
    assets = with_packed_lbs(load_smpl_assets(
        smpl_dir, gender='neutral',
        j_regressor_extra_path=join(data_root, 'J_regressor_extra.npy'),
        j_regressor_h36m_path=join(data_root, 'J_regressor_h36m.npy'),
    ).to(device))
    faces = assets.faces.cpu().numpy()

    # -- GT params ----------------------------------------------------------
    ar = np.asarray(orient_range, np.float32)
    orient = np.stack([
        rng.uniform(-ar[1], ar[1], n),          # ax (pitch-ish)
        rng.uniform(-ar[0], ar[0], n),          # ay (yaw — main signal)
        rng.uniform(-ar[2], ar[2], n),          # az
    ], axis=1).astype(np.float32)
    body_pose = (rng.randn(n, 69) * body_pose_std).astype(np.float32)
    # Articulated subspace: z-axis swings at shoulders (16, 17), elbows
    # (18, 19), knees (4, 5) — all move limbs in the image plane of the
    # upright rest pose. body_pose index = (joint - 1) * 3 + axis.
    for j in (16, 17, 18, 19, 4, 5):
        body_pose[:, (j - 1) * 3 + 2] = rng.uniform(
            -articulation, articulation, n)
    pose = np.concatenate([orient, body_pose], axis=1)  # (n, 72) aa
    betas = (rng.randn(n, 10) * betas_std).astype(np.float32)
    # Root translation: centered, mild jitter, ~4-5 m depth.
    transl = np.stack([
        rng.uniform(-0.2, 0.2, n),
        rng.uniform(-0.1, 0.1, n),
        rng.uniform(4.0, 5.0, n),
    ], axis=1).astype(np.float32)

    K = np.array([[f_pix, 0, W / 2.0],
                  [0, f_pix, H / 2.0],
                  [0, 0, 1]], np.float32)
    eye = np.eye(3, dtype=np.float32)

    # -- one batched forward + projection (the model's own functions) -------
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    t0 = time.perf_counter()
    with torch.inference_mode():
        out = smpl_forward(
            assets, betas=dev(betas),
            body_pose=dev(body_pose.reshape(n, 23, 3)),
            global_orient=dev(orient.reshape(n, 1, 3)),
            pose2rot=True, joint_set='spin49')
        j2d49 = perspective_projection(
            out.joints, rotation=dev(np.tile(eye, (n, 1, 1))),
            translation=dev(transl),
            cam_intrinsics=dev(np.tile(K, (n, 1, 1))))      # (n, 49, 2)
        verts = out.vertices.cpu().numpy()      # (n, V, 3) model frame
        j49 = out.joints.cpu().numpy()          # (n, 49, 3)
        j2d49 = j2d49.cpu().numpy()
    t1 = time.perf_counter()

    # -- render + bbox ------------------------------------------------------
    names, centers, scales = [], [], []
    bg = rng
    for i in range(n):
        rgb, mask = rasterize_mesh(verts[i] + transl[i], faces, K, (H, W))
        # textured gray background so crops are not silhouette-only
        noise = (bg.rand(H, W, 1) * 60 + 90).astype(np.float32) / 255.0
        frame = np.where(mask[..., None], rgb, noise * np.ones(3))
        frame_u8 = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
        nm = f'{dataset}_{i:05d}.jpg'
        writer(frame_u8, join(img_dir, nm), jpeg_quality)
        names.append(nm)
        # SPIN bbox from the GT 2D joints (the real datasets do the same
        # from mocap markers): scale = 1.2 * max_side / 200.
        lo = j2d49[i, 25:].min(0)
        hi = j2d49[i, 25:].max(0)
        centers.append((lo + hi) / 2.0)
        scales.append(1.2 * float((hi - lo).max()) / 200.0)
    if timings is not None:
        timings.update(smpl_s=t1 - t0, render_s=time.perf_counter() - t1)

    S = np.concatenate([j49[:, 25:], np.ones((n, 24, 1), np.float32)], -1)
    part = np.concatenate([j2d49[:, 25:],
                           np.ones((n, 24, 1), np.float32)], -1)
    openpose = np.concatenate([j2d49[:, :25],
                               np.zeros((n, 25, 1), np.float32)], -1)
    vfov = 2.0 * np.arctan(H / (2.0 * f_pix))

    npz = join(extras, _npz_name(dataset))
    np.savez(
        npz,
        imgname=np.array(names),
        scale=np.asarray(scales, np.float32),
        center=np.asarray(centers, np.float32),
        pose_cam=pose,
        pose_0yaw_inverseyz=pose,   # identity camera: world == camera
        shape=betas,
        has_smpl=np.ones(n, np.float32),
        S=S.astype(np.float32),
        part=part.astype(np.float32),
        openpose=openpose.astype(np.float32),
        cam_int=np.tile(K, (n, 1, 1)),
        cam_rotmat=np.tile(eye, (n, 1, 1)),
        camcalib_pitch=np.zeros(n, np.float32),
        camcalib_roll=np.zeros(n, np.float32),
        camcalib_vfov=np.full(n, vfov, np.float32),
        camcalib_f_pix=np.full(n, f_pix, np.float32),
    )
    return npz


def main(argv=None):
    """``python -m spec_tpu_torch.datagen.spec_synth <data_root>`` — render a
    self-consistent synthetic SPEC dataset (frames + npz + SMPL assets)
    into a SPEC_DATA_ROOT layout. Pairs with ``spec_train``/``spec_eval``
    for a checkpoint-free end-to-end train->eval demonstration. SMPL
    runs on ``--device`` (default ``cuda``; ``cpu`` must be asked for)."""
    import argparse

    from spec_tpu_torch.cli._device import add_device_flag, resolve_device

    parser = argparse.ArgumentParser(
        description='synthetic rendered SPEC dataset generator')
    parser.add_argument('data_root',
                        help='output root (point SPEC_DATA_ROOT here)')
    parser.add_argument('--dataset', default='spec-syn',
                        choices=['spec-syn', 'spec-mtp', '3dpw-test-cam'])
    parser.add_argument('--n', type=int, default=256)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--height', type=int, default=256)
    parser.add_argument('--width', type=int, default=320)
    parser.add_argument('--f_pix', type=float, default=400.0)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device, 'spec_tpu_torch.datagen.spec_synth')
    npz = render_spec_synth_dataset(
        args.data_root, dataset=args.dataset, n=args.n, seed=args.seed,
        hw=(args.height, args.width), f_pix=args.f_pix, device=device)
    print(f'[spec-synth] rendered {args.n} {args.dataset} samples; '
          f'annotations at {npz}')


def _npz_name(dataset: str) -> str:
    import os as _os

    from spec_tpu_torch.utils import paths
    # derive the expected filename from the registry so the two can't drift
    old = _os.environ.get('SPEC_DATA_ROOT')
    try:
        _os.environ['SPEC_DATA_ROOT'] = '/'
        return _os.path.basename(paths.dataset_files()[dataset])
    finally:
        if old is None:
            _os.environ.pop('SPEC_DATA_ROOT', None)
        else:
            _os.environ['SPEC_DATA_ROOT'] = old


if __name__ == '__main__':
    main()
