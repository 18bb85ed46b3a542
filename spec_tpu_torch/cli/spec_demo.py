"""SPEC demo CLI: the two-stage pipeline on an image folder, a video file
or a live webcam/stream (port of ``spec_tpu/cli/spec_demo.py``).

* Stage 1 runs in-process: :func:`camcalib_demo.run_camcalib_on_folder`
  (one padded batch per resized shape); its pickles are still written,
  the reference's stage-1 -> stage-2 interface.
* Person boxes come from a file (``--bbox_file``), the in-process YOLOv3
  (``--detector yolo``, ``--yolo_weights``; its boxes are saved as
  ``detections.json``) or one whole-image box per frame.
* Every person crop of every image is cut on the device
  (``serving.crop_boxes``, the port's ``ops/preprocess`` crop) from the
  uploaded frame, and runs in padded batches of ``batch_size`` through
  one stage-2 function: HMR, SMPL through the fused LBS kernel and the
  camera (``serving._spec_forward``); on a GPU it replays a CUDA graph.
* Overlays draw the horizon, the 2D joints and every person's mesh
  (``utils/renderer.render_mesh_overlay``: the host z-buffer of
  ``csrc/raster.cpp`` over the meshes K1 computed on the device). A
  render error is printed once, not swallowed.

Outputs per image: ``spec_results/<img>.pkl`` with the model outputs
(smpl_vertices/joints3d/joints2d, pred_cam_t, pred_pose/shape/cam), and
overlays under ``spec_images/`` unless ``--no_render``.

Usage:
  python -m spec_tpu_torch.cli.spec_demo --image_folder in/ \\
      --output_folder logs/demo [--bbox_file dets.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from spec_tpu_torch.cli._device import add_device_flag, resolve_device
from spec_tpu_torch.data.detection import (
    bbox_to_center_scale,
    full_image_bboxes,
    load_bboxes_file,
    run_yolo_detections,
)
from spec_tpu_torch.data.image_folder import list_images
from spec_tpu_torch.ops.preprocess import spin_crop_corners
from spec_tpu_torch.serving import _spec_forward, build_hmr, crop_boxes
from spec_tpu_torch.utils import paths
from spec_tpu_torch.utils.cam_params import read_cam_params
from spec_tpu_torch.utils.graphs import StageGraph

# Process-level cache: the chunked video demo runs the folder pipeline
# once per chunk; checkpoints load and graphs are captured once.
_MODEL_CACHE: dict = {}

# Uploaded frames kept by the crop loop (work items are grouped by
# image, so a small window suffices).
_IMAGE_CACHE_MAX = 32

def _get_spec_model(smpl_model_dir: str, cfg_file: str, spec_ckpt: str,
                    img_res: Optional[int], device='cuda'):
    """-> (SMPL assets with the fused-LBS operands, HMR, its stage graph),
    all on ``device``; cached per argument set. ``img_res`` None is the
    trunk's crop side (the model's ``img_res``)."""
    from spec_tpu_torch.core import smpl as S

    device = torch.device(device)
    spec_ckpt = spec_ckpt or paths.spec_checkpoint_path()
    key = (smpl_model_dir, cfg_file, spec_ckpt, img_res, str(device))
    if key not in _MODEL_CACHE:
        assets = S.with_packed_lbs(
            S.load_assets_or_test(smpl_model_dir, tag='spec').to(device))
        model = build_hmr(spec_ckpt, device, cfg_file, img_res=img_res,
                          seed=0, tag='spec')
        stage = StageGraph('spec_demo', functools.partial(_spec_forward,
                                                          model, assets))
        _MODEL_CACHE[key] = (assets, model, stage)
    return _MODEL_CACHE[key]


def spec_on_crops(stage, frames_dev, chunk, img_res: int) -> dict:
    """Stage 2 of one padded chunk of work items ``(frame key, center,
    scale, cam_rotmat, K, img_w, img_h)``: crops cut on the device from
    ``frames_dev[frame key]`` (uint8 or float HWC frames on the stage's
    device), then ``stage`` -> the HMR output dict on the device."""
    centers = np.stack([c[1] for c in chunk]).astype(np.float32)
    scales = np.array([c[2] for c in chunk], np.float32)
    crops = crop_boxes(frames_dev, [c[0] for c in chunk],
                       spin_crop_corners(centers, scales, res=img_res),
                       img_res)
    dev = crops.device

    def col(values):
        return torch.from_numpy(np.asarray(values, np.float32)).to(dev)

    with torch.inference_mode():
        return stage(crops, col(np.stack([c[3] for c in chunk])),
                     col(np.stack([c[4] for c in chunk])), col(scales),
                     col(centers), col([c[5] for c in chunk]),
                     col([c[6] for c in chunk]))


def _stage1_keyframes(image_names, every, cut_threshold=0.5):
    """``--camcalib_every`` keyframes of an ordered image list: every Nth
    frame plus any frame whose gray-histogram signature jumps against its
    predecessor (a shot cut; the rule of ``serving.KeyframeSelector``).
    Signatures come from ~96-px thumbnails (PIL ``draft`` decodes JPEGs
    at reduced scale). An unreadable frame keeps the previous
    signature."""
    from PIL import Image

    from spec_tpu_torch.serving import KeyframeSelector, frame_signature

    sel = KeyframeSelector(every, cut_threshold)
    keys = []
    for name in image_names:
        sig = None
        if sel.cut_threshold > 0:
            try:
                with Image.open(name) as im:
                    im.draft('L', (96, 96))
                    im = im.convert('L')
                    im.thumbnail((96, 96))
                    sig = frame_signature(np.asarray(im))
            except OSError:
                sig = None
        if sel.is_keyframe(sig):
            keys.append(name)
    return keys


def _carry_cameras_forward(image_names, cam_out, shapes):
    """``--camcalib_every`` fill: every image without a stage-1 pickle
    gets its latest preceding keyframe's camera, with f_pix (defined
    w.r.t. the frame height) rescaled when the frame height differs."""
    import joblib

    last = None
    last_h = 0
    for name in image_names:
        base = os.path.basename(name)
        pkl = os.path.join(cam_out, base + '.pkl')
        if os.path.exists(pkl):
            last = joblib.load(pkl)
            last_h = shapes[base][0]
        elif last is not None:
            d = dict(last)
            h = shapes[base][0]
            if h != last_h:
                d['f_pix'] = float(h / (2.0 * np.tan(d['vfov'] / 2)))
            joblib.dump(d, pkl)


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f'cannot read image {path}')
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def run_spec_on_folder(
    image_folder: str,
    output_folder: str,
    spec_ckpt: str = '',
    camcalib_ckpt: str = '',
    bbox_file: str = '',
    batch_size: int = 32,
    img_res: Optional[int] = None,
    save_results: bool = True,
    render: bool = True,
    smpl_model_dir: str = '',
    save_obj: bool = False,
    cfg_file: str = '',
    detection_threshold: float = 0.7,
    detector: str = '',
    yolo_weights: str = '',
    yolo_img_size: int = 416,
    min_size: int = 600,
    camcalib_every: int = 1,
    cut_threshold: float = 0.5,
    device='cuda',
):
    import joblib
    from PIL import Image

    from spec_tpu_torch.cli.camcalib_demo import run_camcalib_on_folder

    if detector not in ('', 'yolo'):
        raise ValueError(f"unknown detector {detector!r}; use 'yolo' or "
                         "'' (--bbox_file or full-frame boxes)")
    t_total_start = time.perf_counter()
    cam_out = os.path.join(output_folder, 'camcalib')
    res_out = os.path.join(output_folder, 'spec_results')
    img_out = os.path.join(output_folder, 'spec_images')
    for d in (cam_out, res_out, img_out):
        os.makedirs(d, exist_ok=True)

    # Detections.
    image_names = list_images(image_folder)
    shapes = {}
    for name in image_names:
        with Image.open(name) as im:
            w, h = im.size
        shapes[os.path.basename(name)] = (h, w)
    if bbox_file:
        dets = load_bboxes_file(bbox_file)
    elif detector == 'yolo':
        import json

        dets = run_yolo_detections(
            image_names, yolo_weights, img_size=yolo_img_size,
            conf_thresh=detection_threshold, device=device)
        # Saved (merged across the video mode's chunks) so tracking and
        # users read them as any --bbox_file.
        det_json = os.path.join(output_folder, 'detections.json')
        merged = {}
        if os.path.exists(det_json):
            with open(det_json) as f:
                merged = json.load(f)
        merged.update({k: np.asarray(v).tolist() for k, v in dets.items()})
        with open(det_json, 'w') as f:
            json.dump(merged, f)
    else:
        print('[spec] no --bbox_file given; using full-frame boxes')
        dets = full_image_bboxes(shapes)

    assets, model, stage = _get_spec_model(smpl_model_dir, cfg_file,
                                           spec_ckpt, img_res, device)
    img_res = model.img_res
    dev = assets.device
    t_start = time.perf_counter()

    # Stage 1: CamCalib in-process, one padded batch per resized shape.
    camcalib_every = max(1, int(camcalib_every))
    cam_list = (image_names if camcalib_every == 1
                else _stage1_keyframes(image_names, camcalib_every,
                                       cut_threshold=cut_threshold))
    run_camcalib_on_folder(
        image_folder, cam_out, ckpt=camcalib_ckpt, save_images=False,
        min_size=min_size, image_list=cam_list, device=dev)
    if camcalib_every > 1:
        _carry_cameras_forward(image_names, cam_out, shapes)

    # Every detection of every image, in one work list.
    work = []  # (imgname, center, scale, cam_rotmat, K, w, h)
    for name in image_names:
        base = os.path.basename(name)
        if base not in dets or len(dets[base]) == 0:
            continue
        h, w = shapes[base]
        rotmat, K, *_ = read_cam_params(
            os.path.join(cam_out, base + '.pkl'), w, h)
        centers, scales = bbox_to_center_scale(dets[base])
        for di in range(len(centers)):
            work.append((name, centers[di], scales[di], rotmat, K, w, h))

    frames_dev: dict = {}     # imgname -> uint8 frame on the device (LRU)
    n_model_time = 0.0
    outputs_per_image: dict = {}
    for s in range(0, len(work), batch_size):
        chunk = work[s:s + batch_size]
        n_valid = len(chunk)
        chunk = chunk + [chunk[-1]] * (batch_size - n_valid)
        needed = list(dict.fromkeys(c[0] for c in chunk))
        for name in needed:                # uploaded or touched (LRU)
            frames_dev[name] = (frames_dev.pop(name) if name in frames_dev
                                else torch.from_numpy(_read_rgb(name)).to(dev))
        # At most _IMAGE_CACHE_MAX frames stay, never one this chunk needs.
        stale = [k for k in frames_dev if k not in needed]
        for k in stale[:max(0, len(frames_dev) - _IMAGE_CACHE_MAX)]:
            del frames_dev[k]
        t0 = time.perf_counter()
        out = spec_on_crops(stage, frames_dev, chunk, img_res)
        out_np = {k: v.cpu().numpy() for k, v in out.items()}
        n_model_time += time.perf_counter() - t0
        for bi in range(n_valid):
            outputs_per_image.setdefault(chunk[bi][0], []).append(
                {k: v[bi] for k, v in out_np.items()})

    # Per-image results (the reference's spec/tester.py layout).
    faces = assets.faces.cpu().numpy()
    for name, person_outs in outputs_per_image.items():
        merged = {k: np.stack([p[k] for p in person_outs])
                  for k in person_outs[0]}
        base = os.path.basename(name)
        stem = base.rsplit('.', 1)[0]
        if save_results:
            joblib.dump(merged, os.path.join(res_out, stem + '.pkl'))
        if save_obj:
            mesh_dir = os.path.join(output_folder, 'meshes', stem)
            os.makedirs(mesh_dir, exist_ok=True)
            for pi, verts in enumerate(merged['smpl_vertices']):
                write_obj(os.path.join(mesh_dir, f'{pi:06d}.obj'), verts,
                          faces)
                np.save(os.path.join(mesh_dir, f'{pi:06d}.npy'),
                        merged['pred_cam_t'][pi])
        if render:
            _render_overlays(name, merged, cam_out, img_out, faces)

    n_img = len(outputs_per_image)
    total = time.perf_counter() - t_start
    total_with_load = time.perf_counter() - t_total_start
    print(f'[spec] {n_img} images / {len(work)} crops; model time '
          f'{n_model_time:.2f}s; e2e {total:.2f}s '
          f'({n_img / max(total, 1e-6):.1f} img/s excl. load, '
          f'{n_img / max(total_with_load, 1e-6):.1f} img/s incl. load)')
    return outputs_per_image


def _smooth_video_tracks(output_folder, vid_file, names, per_frame, ids,
                         fps, frame_hw, folder_kwargs,
                         min_cutoff=None, beta=None):
    """``--smooth``: One-Euro-filter each track's SMPL parameters,
    recompute vertices and joints in padded batches on the device
    (``smpl_cam_head``, SMPL through the fused LBS kernel), rewrite the
    result pickles and re-encode the annotated video."""
    import cv2
    import joblib

    from spec_tpu_torch.models.heads.smpl_head import smpl_cam_head
    from spec_tpu_torch.utils.batching import pad_pow2
    from spec_tpu_torch.utils.smoothing import smooth_track_params

    res_out = os.path.join(output_folder, 'spec_results')
    cam_out = os.path.join(output_folder, 'camcalib')
    h, w = frame_hw
    assets, model, _ = _get_spec_model(
        folder_kwargs.get('smpl_model_dir', ''),
        folder_kwargs.get('cfg_file', ''), folder_kwargs.get('spec_ckpt', ''),
        folder_kwargs.get('img_res'), folder_kwargs.get('device', 'cuda'))
    img_res = model.img_res
    dev = assets.device
    faces = assets.faces.cpu().numpy()

    # Per-frame results and cameras.
    results, cam_params, cam_raw = {}, {}, {}
    for fi, name in enumerate(names):
        stem = name.rsplit('.', 1)[0]
        p = os.path.join(res_out, stem + '.pkl')
        if os.path.exists(p):
            results[fi] = joblib.load(p)
            rotmat, K, *_ = read_cam_params(
                os.path.join(cam_out, name + '.pkl'), w, h)
            cam_params[fi] = (rotmat, K)
            cam_raw[fi] = joblib.load(os.path.join(cam_out, name + '.pkl'))

    # (frame, person) rows grouped into tracks; each track smoothed.
    by_track: dict = {}
    for fi, tid_arr in enumerate(ids):
        for pi, tid in enumerate(tid_arr):
            if fi in results and pi < len(results[fi]['pred_pose']):
                by_track.setdefault(int(tid), []).append((fi, pi))
    items = []   # (fi, pi, pose (24, 3, 3), betas (10,), cam (3,))
    for tid, fps_pis in by_track.items():
        fps_pis.sort()
        r = {k: np.stack([results[fi][k][pi] for fi, pi in fps_pis])
             for k in ('pred_pose', 'pred_shape', 'pred_cam')}
        kw = {}
        if min_cutoff is not None:
            kw['min_cutoff'] = min_cutoff
        if beta is not None:
            kw['beta'] = beta
        # Tracks bridge occlusions: pass the rows' frame indices.
        sm = smooth_track_params(
            r['pred_pose'], r['pred_shape'], r['pred_cam'], fps,
            frames=np.asarray([fi for fi, _ in fps_pis]), **kw)
        for t, (fi, pi) in enumerate(fps_pis):
            items.append((fi, pi, sm['pose'][t], sm['betas'][t],
                          sm['cam'][t]))
    if not items:
        return

    recompute = StageGraph('spec_demo_smooth', functools.partial(
        smpl_cam_head, assets, crop_res=img_res))

    def col(values):
        return torch.from_numpy(np.asarray(values, np.float32)).to(dev)

    B = 64
    for s0 in range(0, len(items), B):
        chunk = items[s0:s0 + B]
        n_valid = len(chunk)
        chunk = chunk + [chunk[-1]] * (pad_pow2(n_valid, B) - n_valid)
        centers, scales = bbox_to_center_scale(
            np.stack([per_frame[fi][pi] for fi, pi, *_ in chunk]))
        with torch.inference_mode():
            out = recompute(
                col(np.stack([it[2] for it in chunk])),
                col(np.stack([it[3] for it in chunk])),
                col(np.stack([it[4] for it in chunk])),
                col(np.stack([cam_params[it[0]][0] for it in chunk])),
                col(np.stack([cam_params[it[0]][1] for it in chunk])),
                col(scales), col(centers), col([w] * len(chunk)),
                col([h] * len(chunk)))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for bi in range(n_valid):
            fi, pi, pose, betas, cam = chunk[bi]
            r = results[fi]
            for k in ('smpl_vertices', 'smpl_joints3d', 'smpl_joints2d',
                      'pred_cam_t'):
                if k in r:
                    r[k][pi] = out[k][bi]
            r['pred_pose'][pi] = pose
            r['pred_shape'][pi] = betas
            r['pred_cam'][pi] = cam

    for fi, r in results.items():
        stem = names[fi].rsplit('.', 1)[0]
        joblib.dump(r, os.path.join(res_out, stem + '.pkl'))

    if not folder_kwargs.get('render', True):
        print(f'[spec] smoothed {len(items)} person-frames across '
              f'{len(by_track)} tracks (render off: pickles only)')
        return

    # Re-encode the annotated video from the smoothed results (a second
    # decode: the chunked frames were deleted).
    cap = cv2.VideoCapture(vid_file)
    tmp_path = os.path.join(output_folder, '.spec_video_smooth.mp4')
    out_path = os.path.join(output_folder, 'spec_video_output.mp4')
    vw, fi = None, 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if vw is None:
            fh, fw = frame.shape[:2]
            vw = cv2.VideoWriter(tmp_path, cv2.VideoWriter_fourcc(*'mp4v'),
                                 fps, (fw, fh))
        if fi in results:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            vis = _render_overlay_img(rgb, results[fi], cam_raw[fi], faces)
            frame = cv2.cvtColor(vis, cv2.COLOR_RGB2BGR)
        vw.write(frame)
        fi += 1
    cap.release()
    if vw is not None:
        vw.release()
        os.replace(tmp_path, out_path)
    print(f'[spec] smoothed {len(items)} person-frames across '
          f'{len(by_track)} tracks; re-encoded {out_path}')


def run_spec_on_video(
    vid_file: str,
    output_folder: str,
    keep_frames: bool = False,
    chunk_size: int = 500,
    smooth: bool = False,
    smooth_min_cutoff: Optional[float] = None,
    smooth_beta: Optional[float] = None,
    tracker: str = 'sort',
    **folder_kwargs,
):
    """Video demo: decode frames -> the folder pipeline -> an annotated
    video (``spec_video_output.mp4`` at the source fps).

    Frames are processed in windows of ``chunk_size`` (decode the chunk,
    run the pipeline, append to the output video, delete the chunk's
    pngs), so a long clip never lies on disk in full; ``keep_frames``
    moves processed frames to ``frames/``. Person boxes are tracked
    across frames (``tracking.pkl``); ``smooth`` smooths each track
    (:func:`_smooth_video_tracks`). Returns the output video path.
    """
    import shutil

    import cv2
    import joblib

    cap = cv2.VideoCapture(vid_file)
    if not cap.isOpened():
        raise FileNotFoundError(f'cannot open video: {vid_file}')
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0

    # Video-mode detections are keyed by the generated frame names
    # (000000.png, ...): fail before decoding if none follows that.
    vid_dets = None
    if folder_kwargs.get('bbox_file'):
        vid_dets = load_bboxes_file(folder_kwargs['bbox_file'])
        if not any(re.fullmatch(r'\d{6}\.(png|jpg)', k) for k in vid_dets):
            raise ValueError(
                f'--bbox_file {folder_kwargs["bbox_file"]!r} has no '
                f"frame-name-convention keys; video-mode bbox files must "
                f"be keyed by decoded frame names '000000.png', "
                f"'000001.png', ... "
                f'(got keys like {sorted(vid_dets)[:3]})')
    work_dir = os.path.join(output_folder, 'frames_chunk')
    kept_dir = os.path.join(output_folder, 'frames')
    os.makedirs(work_dir, exist_ok=True)
    if keep_frames:
        os.makedirs(kept_dir, exist_ok=True)

    img_out = os.path.join(output_folder, 'spec_images')
    out_path = os.path.join(output_folder, 'spec_video_output.mp4')
    vw = None
    names: list = []          # all frame names, in order
    chunk: list = []          # names of the current chunk

    def flush(chunk_names):
        nonlocal vw
        if not chunk_names:
            return
        run_spec_on_folder(work_dir, output_folder, **folder_kwargs)
        for name in chunk_names:
            src = os.path.join(work_dir, name)
            rend = os.path.join(img_out, name)
            frame = cv2.imread(rend if os.path.exists(rend) else src)
            if vw is None:
                fh, fw = frame.shape[:2]
                vw = cv2.VideoWriter(
                    out_path, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                    (fw, fh))
            vw.write(frame)
            if keep_frames:
                shutil.move(src, os.path.join(kept_dir, name))
            else:
                os.remove(src)

    first_hw = None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if first_hw is None:
            first_hw = frame.shape[:2]
        name = f'{len(names):06d}.png'  # png: lossless round trip
        cv2.imwrite(os.path.join(work_dir, name), frame)
        names.append(name)
        chunk.append(name)
        if len(chunk) >= chunk_size:
            flush(chunk)
            chunk = []
    cap.release()
    flush(chunk)
    if not names:
        shutil.rmtree(work_dir, ignore_errors=True)
        raise ValueError(f'no frames decoded from {vid_file}')
    vw.release()
    shutil.rmtree(work_dir, ignore_errors=True)

    from spec_tpu_torch.data.tracking import track_video_boxes

    h, w = first_hw
    if vid_dets is not None:
        dets = vid_dets
    elif folder_kwargs.get('detector') == 'yolo':
        # run_spec_on_folder saved each chunk's detections.
        dets = load_bboxes_file(
            os.path.join(output_folder, 'detections.json'))
    else:
        dets = full_image_bboxes({n: (h, w) for n in names})
    per_frame = [np.asarray(dets.get(n, np.zeros((0, 4), np.float32)),
                            np.float32).reshape(-1, 4) for n in names]
    ids = track_video_boxes(per_frame, method=tracker)
    tracks: dict = {}
    for fi, (bx, tid_arr) in enumerate(zip(per_frame, ids)):
        for b, tid in zip(bx, tid_arr):
            tr = tracks.setdefault(int(tid), {'frames': [], 'bboxes': []})
            tr['frames'].append(fi)
            tr['bboxes'].append(np.asarray(b))
    tracks = {tid: {'frames': np.asarray(t['frames']),
                    'bboxes': np.stack(t['bboxes'])}
              for tid, t in tracks.items()}
    joblib.dump(tracks, os.path.join(output_folder, 'tracking.pkl'))

    if smooth and folder_kwargs.get('save_results', True):
        _smooth_video_tracks(output_folder, vid_file, names, per_frame,
                             ids, fps, (h, w), folder_kwargs,
                             min_cutoff=smooth_min_cutoff,
                             beta=smooth_beta)
    elif smooth:
        print('[spec] WARNING: --smooth needs saved results; skipped '
              '(drop --no_save)')

    print(f'[spec] wrote {out_path} ({len(names)} frames @ {fps:.1f} fps)')
    return out_path


def run_spec_webcam(
    source: str = '0',
    output_folder: str = 'logs/demo',
    spec_ckpt: str = '',
    camcalib_ckpt: str = '',
    cfg_file: str = '',
    smpl_model_dir: str = '',
    detector: str = '',
    yolo_weights: str = '',
    yolo_img_size: int = 416,
    min_size: int = 600,
    img_res: Optional[int] = None,
    max_frames: int = 0,
    display: bool = False,
    save_results: bool = True,
    camcalib_every: int = 1,
    cut_threshold: float = 0.5,
    device='cuda',
):
    """Webcam / live-stream demo: a per-frame loop on the serving engine
    (:class:`spec_tpu_torch.serving.SpecPredictor`), the latency path.

    ``source`` is a camera index ('0', '1', ...) or any cv2-readable
    stream or file. Per frame: the detector's boxes (``detector='yolo'``)
    or a full-frame person box -> CamCalib (on
    ``camcalib_every`` keyframes) -> SPEC -> horizon, joints and mesh
    overlay
    -> ``spec_webcam_output.mp4`` (and a ``cv2.imshow`` window with
    ``display``; ``q`` quits). Per-frame results go to
    ``webcam_results/{i:06d}.pkl``. Prints mean/p50/p90 end-to-end
    latency. Returns (n_frames, latencies_ms).
    """
    import cv2
    import joblib

    from spec_tpu_torch.serving import (
        KeyframeSelector,
        SpecPredictor,
        frame_signature,
    )
    from spec_tpu_torch.utils.vis import draw_horizon_line

    cap = cv2.VideoCapture(int(source) if source.isdigit() else source)
    if not cap.isOpened():
        raise FileNotFoundError(f'cannot open capture source: {source!r}')
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0

    os.makedirs(output_folder, exist_ok=True)
    res_out = os.path.join(output_folder, 'webcam_results')
    if save_results:
        os.makedirs(res_out, exist_ok=True)

    # batch_size 8: few padded shapes (1/2/4/8 persons), and a lone
    # person costs a one-crop batch.
    pred = SpecPredictor(
        spec_ckpt=spec_ckpt, camcalib_ckpt=camcalib_ckpt,
        cfg_file=cfg_file, smpl_model_dir=smpl_model_dir, img_res=img_res,
        batch_size=8, min_size=min_size, detector=detector,
        yolo_weights=yolo_weights, yolo_img_size=yolo_img_size,
        cut_threshold=cut_threshold, device=device)

    faces = pred.assets.faces.cpu().numpy()
    out_path = os.path.join(output_folder, 'spec_webcam_output.mp4')
    vw = None
    latencies: list = []
    fi = 0
    sel = KeyframeSelector(camcalib_every, pred.cut_threshold)
    while True:
        ok, frame_bgr = cap.read()
        if not ok:
            break
        rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
        h, w = rgb.shape[:2]

        t0 = time.perf_counter()
        # Stage 1 runs on its own, so person-less frames get a horizon
        # too; predict() reuses it through ``cameras=``. A shot cut
        # forces an off-stride keyframe.
        if sel.is_keyframe(frame_signature(rgb)
                           if camcalib_every > 1 and sel.cut_threshold > 0
                           else None):
            cam = pred.estimate_cameras([rgb])[0]
        if pred.detector is not None:
            persons = pred.predict([rgb], cameras=[cam])[0]
        else:
            full = full_image_bboxes({'f': (h, w)})['f']
            persons = pred.predict([rgb], [full], cameras=[cam])[0]
        latencies.append((time.perf_counter() - t0) * 1000.0)

        if persons:
            merged = {k: np.stack([p[k] for p in persons])
                      for k in persons[0] if k != 'camera'}
            vis = _render_overlay_img(rgb, merged, cam, faces)
        else:
            merged = None
            vis = draw_horizon_line(rgb, cam['vfov'], cam['pitch'],
                                    cam['roll'], debug_text=False)

        if save_results:
            dump = dict(merged or {})
            dump['camera'] = cam
            joblib.dump(dump, os.path.join(res_out, f'{fi:06d}.pkl'))

        out_bgr = cv2.cvtColor(vis, cv2.COLOR_RGB2BGR)
        if vw is None:
            vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*'mp4v'),
                                 fps, (w, h))
        vw.write(out_bgr)
        if display:
            try:
                cv2.imshow('spec', out_bgr)
                if (cv2.waitKey(1) & 0xFF) == ord('q'):
                    break
            except cv2.error:
                print('[spec] WARNING: no display available; '
                      'continuing headless')
                display = False
        fi += 1
        if max_frames and fi >= max_frames:
            break
    cap.release()
    if vw is not None:
        vw.release()
    if display:
        cv2.destroyAllWindows()

    if latencies:
        srt = sorted(latencies)

        def p(q):
            return srt[min(len(srt) - 1, int(q * len(srt)))]

        print(f'[spec] webcam: {fi} frames -> {out_path}; e2e latency '
              f'mean {np.mean(latencies):.1f} ms, p50 {p(0.5):.1f} ms, '
              f'p90 {p(0.9):.1f} ms (first frame incl. capture '
              f'{latencies[0]:.0f} ms)')
    else:
        print(f'[spec] webcam: no frames read from source {source!r}')
    return fi, latencies


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Wavefront OBJ export (the ``--save_obj`` path; the camera
    translation goes to a sidecar .npy)."""
    with open(path, 'w') as f:
        for v in vertices:
            f.write(f'v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n')
        for tri in faces:
            f.write(f'f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n')


@functools.cache
def _say_render_error(message: str) -> None:
    print(f'[spec] mesh overlay not drawn: {message}')


def _render_overlay_img(img_rgb, merged, cam_data, faces):
    """Horizon, 2D joints and every person's mesh over an RGB frame
    (``merged['smpl_vertices']`` placed by ``merged['pred_cam_t']``,
    CamCalib's f_pix, pitch and roll). A render error leaves the mesh out
    and is printed once per message."""
    from spec_tpu_torch.utils.renderer import render_mesh_overlay
    from spec_tpu_torch.utils.vis import draw_horizon_line, draw_skeleton

    vis = draw_horizon_line(img_rgb, float(cam_data['vfov']),
                            float(cam_data['pitch']),
                            float(cam_data['roll']), debug_text=False)
    for kp in merged['smpl_joints2d']:
        vis = draw_skeleton(vis, kp)
    try:
        vis = render_mesh_overlay(
            vis, merged['smpl_vertices'], merged['pred_cam_t'], faces,
            focal_length=float(cam_data['f_pix']),
            pitch=float(cam_data['pitch']), roll=float(cam_data['roll']))
    except Exception as e:   # noqa: BLE001 -- reported, not swallowed
        _say_render_error(f'{type(e).__name__}: {e}')
    return vis


def _render_overlays(imgname, merged, cam_out, img_out, faces):
    """File-based wrapper over :func:`_render_overlay_img`."""
    import cv2
    import joblib

    base = os.path.basename(imgname)
    data = joblib.load(os.path.join(cam_out, base + '.pkl'))
    vis = _render_overlay_img(_read_rgb(imgname), merged, data, faces)
    cv2.imwrite(os.path.join(img_out, base),
                cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='SPEC demo (PyTorch)')
    parser.add_argument('--image_folder', type=str, default='',
                        help='input folder (folder mode)')
    parser.add_argument('--output_folder', type=str, default='logs/demo')
    parser.add_argument('--spec_ckpt', type=str, default='')
    parser.add_argument('--cfg', type=str, default='',
                        help='model config yaml shipped with the '
                             'checkpoint (HMR.BACKBONE / USE_CAM_FEATS)')
    parser.add_argument('--camcalib_ckpt', type=str, default='')
    parser.add_argument('--bbox_file', type=str, default='',
                        help='precomputed detections json/npz '
                             '{img: [[cx,cy,w,h],...]}; in --mode video '
                             'keys must be the decoded frame names '
                             "'000000.png', '000001.png', ...")
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--min_size', type=int, default=600,
                        help='stage-1 (CamCalib) min-side resize bucket')
    parser.add_argument('--camcalib_every', type=int, default=1,
                        help='run stage 1 (CamCalib) only on every Nth '
                             'frame and reuse the latest keyframe camera '
                             'in between; hard shot cuts (gray-histogram '
                             'delta) force an off-stride keyframe. 1 '
                             '(default) = every frame')
    parser.add_argument('--cut_threshold', type=float, default=0.5,
                        help='shot-cut re-anchor sensitivity for '
                             '--camcalib_every: gray-histogram L1 delta '
                             '(in [0, 2]) above which a frame becomes an '
                             'off-stride keyframe; 0 disables')
    parser.add_argument('--no_save', action='store_true')
    parser.add_argument('--no_render', action='store_true')
    parser.add_argument('--save_obj', action='store_true')
    parser.add_argument('--smpl_model_dir', type=str, default='')
    parser.add_argument('--vid_file', type=str, default=None,
                        help='video input (implies --mode video)')
    parser.add_argument('--mode', type=str, default='folder',
                        choices=['folder', 'video', 'webcam'])
    parser.add_argument('--chunk_size', type=int, default=500,
                        help='video mode: frames decoded and processed '
                             'per window (bounds disk use)')
    parser.add_argument('--keep_frames', action='store_true',
                        help='video mode: keep decoded frames on disk')
    # The reference's flag surface: --ckpt is its name for the SPEC
    # checkpoint, --exp suffixes the output directory; the tracker and
    # render-extra flags are accepted and unused, as in the reference.
    parser.add_argument('--ckpt', type=str, default='',
                        help='alias for --spec_ckpt (reference name)')
    parser.add_argument('--exp', type=str, default='',
                        help='experiment suffix appended to the output dir')
    parser.add_argument('--detector', type=str, default='',
                        choices=['', 'yolo', 'maskrcnn'],
                        help="'yolo' runs the in-process YOLOv3 "
                             '(--yolo_weights; random init without); '
                             'default is '
                             '--bbox_file or full-frame boxes')
    parser.add_argument('--yolo_weights', type=str, default='',
                        help='path to the official darknet '
                             'yolov3.weights for --detector yolo')
    parser.add_argument('--yolo_img_size', type=int, default=416,
                        help='--detector yolo letterbox size (a multiple '
                             'of 32)')
    for noop in ('--tracking_method', '--staf_dir'):
        parser.add_argument(noop, type=str, default=None,
                            help='accepted for reference CLI parity; '
                                 'detection is pluggable via --bbox_file')
    parser.add_argument('--tracker_batch_size', type=int, default=None,
                        help='accepted for reference CLI parity')
    parser.add_argument('--tracker', type=str, default='sort',
                        choices=['sort', 'iou'],
                        help='[video] identity tracker: sort (Kalman + '
                             'Hungarian) or iou (greedy last-box IoU)')
    parser.add_argument('--min_cutoff', type=float, default=None,
                        help='[video --smooth] One-Euro cutoff floor Hz '
                             '(default 0.004; lower = smoother at rest)')
    parser.add_argument('--beta', type=float, default=None,
                        help='[video --smooth] One-Euro speed coeff '
                             '(default 0.7; higher = less motion lag)')
    parser.add_argument('--smooth', action='store_true',
                        help="[video mode] One-Euro-smooth each track's "
                             'SMPL params and recompute the meshes')
    for noop in ('--wireframe', '--sideview', '--draw_keypoints'):
        parser.add_argument(noop, action='store_true',
                            help='accepted; unused (as in the reference '
                                 'tester)')
    parser.add_argument('--display', action='store_true',
                        help='[webcam mode] live cv2 window (q quits)')
    parser.add_argument('--webcam_source', type=str, default='0',
                        help='[webcam mode] camera index or any '
                             'cv2-readable stream/file URL')
    parser.add_argument('--max_frames', type=int, default=0,
                        help='[webcam mode] stop after N frames '
                             '(0 = until the stream ends / q)')
    add_device_flag(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.vid_file and args.mode == 'folder':
        args.mode = 'video'
    if args.mode == 'video' and not args.vid_file:
        raise SystemExit('--mode video requires --vid_file')
    if args.mode == 'folder' and not args.image_folder:
        raise SystemExit('--image_folder is required in folder mode')
    if args.detector == 'maskrcnn':
        raise SystemExit(
            '--detector maskrcnn is not bundled; precompute boxes with '
            'any detector and pass --bbox_file')
    if args.detector == 'yolo' and not args.yolo_weights:
        print('[spec] WARNING: --detector yolo without --yolo_weights '
              'runs a random-init detector (pipeline check only); point '
              '--yolo_weights at the official darknet yolov3.weights')
    device = resolve_device(args.device, 'spec_tpu_torch.cli.spec_demo')
    if args.ckpt and not args.spec_ckpt:
        args.spec_ckpt = args.ckpt
    out_folder = args.output_folder
    if args.exp:
        # <output>/<input basename>_<exp>
        src = {'video': args.vid_file,
               'webcam': f'webcam{args.webcam_source}'
                         if args.webcam_source.isdigit()
                         else args.webcam_source,
               }.get(args.mode, args.image_folder)
        out_folder = os.path.join(
            out_folder,
            os.path.basename(src.rstrip('/')).rsplit('.', 1)[0]
            + '_' + args.exp)
    common = dict(
        spec_ckpt=args.spec_ckpt, camcalib_ckpt=args.camcalib_ckpt,
        bbox_file=args.bbox_file, batch_size=args.batch_size,
        save_results=not args.no_save, render=not args.no_render,
        smpl_model_dir=args.smpl_model_dir, save_obj=args.save_obj,
        cfg_file=args.cfg, detector=args.detector,
        yolo_weights=args.yolo_weights, yolo_img_size=args.yolo_img_size,
        min_size=args.min_size, camcalib_every=args.camcalib_every,
        cut_threshold=args.cut_threshold, device=device)
    if args.mode == 'webcam':
        if args.bbox_file:
            print('[spec] WARNING: --bbox_file is ignored in webcam mode '
                  '(live frames have no precomputed boxes); use '
                  '--detector yolo or the full-frame fallback')
        run_spec_webcam(
            source=args.webcam_source, output_folder=out_folder,
            spec_ckpt=args.spec_ckpt, camcalib_ckpt=args.camcalib_ckpt,
            cfg_file=args.cfg, smpl_model_dir=args.smpl_model_dir,
            detector=args.detector, yolo_weights=args.yolo_weights,
            yolo_img_size=args.yolo_img_size,
            min_size=args.min_size, max_frames=args.max_frames,
            display=args.display, save_results=not args.no_save,
            camcalib_every=args.camcalib_every,
            cut_threshold=args.cut_threshold, device=device)
    elif args.mode == 'video':
        run_spec_on_video(args.vid_file, out_folder,
                          chunk_size=args.chunk_size,
                          keep_frames=args.keep_frames,
                          smooth=args.smooth,
                          smooth_min_cutoff=args.min_cutoff,
                          smooth_beta=args.beta,
                          tracker=args.tracker, **common)
    else:
        if args.smooth:
            print('[spec] WARNING: --smooth is temporal and applies to '
                  '--mode video only; ignored in folder mode')
        run_spec_on_folder(args.image_folder, out_folder, **common)


if __name__ == '__main__':
    main()
