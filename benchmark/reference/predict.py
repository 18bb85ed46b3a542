"""SPEC's two-stage inference in plain PyTorch: CamCalib on each stream
keyframe (resized to the configuration's short side), the keyframe's
camera for the frames that follow it, SPIN crops of every person box,
the regressor, SMPL and the full-frame projection. Float32; the caller
sets TF32 (``precision``). Inputs are the benchmark's own: frames, boxes,
the networks' state and the raw SMPL assets."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import geometry as G
from benchmark.reference import image
from benchmark.reference.smpl import cam_head

BLOCK = 64      # persons per regressor forward (bounds the reference's memory)


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and convolutions with TF32 on or off, restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@torch.no_grad()
def camera(camcalib, frame_u8: np.ndarray, min_size: int, device) -> dict:
    """CamCalib on one frame: vfov, pitch, roll (radians) and the focal
    length in pixels of the frame's own height."""
    x = image.resize_min_side(torch.from_numpy(frame_u8).to(device),
                              min_size)
    logits = camcalib(image.normalize(x[None].float() / 255.0))
    vfov = image.softargmax_angle(logits[0], *image.VFOV_RANGE)[0]
    pitch = image.softargmax_angle(logits[1], *image.PITCH_RANGE)[0]
    roll = image.softargmax_angle(logits[2], *image.ROLL_RANGE)[0]
    h = frame_u8.shape[0]
    return {'vfov': float(vfov), 'pitch': float(pitch), 'roll': float(roll),
            'f_pix': h / 2.0 / float(torch.tan(vfov / 2.0))}


def stream_cameras(camcalib, frames, start, every, threshold, min_size,
                   device) -> list:
    """Each frame's camera under the keyframe rule: CamCalib on the
    keyframes, the latest keyframe's camera in between (its focal length
    rescaled to the frame's height)."""
    keys = set(image.keyframes(frames, start, every, threshold))
    cams, cam = [], None
    for i, fr in enumerate(frames):
        if i in keys:
            cam = camera(camcalib, fr, min_size, device)
        c = dict(cam)
        c['f_pix'] = fr.shape[0] / (2.0 * np.tan(c['vfov'] / 2.0))
        cams.append(c)
    return cams


@torch.no_grad()
def persons(hmr, assets, frames, boxes, cams, res: int, device) -> list:
    """Per frame, per person: the regressor's outputs and the SMPL head's,
    as float32 numpy arrays."""
    rows = []                              # (frame, crop inputs)
    for fi, (fr, bx) in enumerate(zip(frames, boxes)):
        bx = np.asarray(bx, np.float32).reshape(-1, 4)
        for b in bx:
            center = b[:2].astype(np.float32)
            scale = np.float32(max(b[2], b[3]) / np.float32(200.0))
            rows.append((fi, center, scale))
    out = [[] for _ in frames]
    dev_frames = {}
    for s0 in range(0, len(rows), BLOCK):
        blk = rows[s0:s0 + BLOCK]
        crops = []
        for fi, center, scale in blk:
            if fi not in dev_frames:
                dev_frames[fi] = torch.from_numpy(frames[fi]).to(
                    device).float()
            crops.append(image.crop(dev_frames[fi],
                                    image.spin_corners(center, scale, res),
                                    res))
        x = image.normalize(torch.stack(crops) / 255.0)
        hmr_out = hmr(x)
        fis = [r[0] for r in blk]

        def col(vals):
            return torch.tensor(np.asarray(vals, np.float32), device=device)

        pitch = col([cams[f]['pitch'] for f in fis])
        roll = col([cams[f]['roll'] for f in fis])
        smpl_out = cam_head(
            assets, hmr_out, G.euler_to_rotmat(pitch, roll),
            col([cams[f]['f_pix'] for f in fis]),
            col([r[1] for r in blk]), col([r[2] for r in blk]),
            col([frames[f].shape[1] for f in fis]),
            col([frames[f].shape[0] for f in fis]), res)
        both = {**hmr_out, **smpl_out}
        host = {k: v.float().cpu().numpy() for k, v in both.items()}
        for k, fi in enumerate(fis):
            out[fi].append({n: v[k] for n, v in host.items()})
    return out
