#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spec_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its own results; any failure raises and exits nonzero:

1. device: CUDA must be available (there is no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the three kernels of ``spec_tpu_torch/csrc/`` (K1
   ``lbs``, K3 ``bottleneck``, K2 ``projection``), one ``nvcc`` each,
   all started together;
3. K3 against its plain version at every ResNet-50 stage's identity-block
   shape on 16 frames of 512x672 (one block each) and at an odd H and W
   (a chain of 3), in fp32 and bf16, timed beside the port's unfused
   cuDNN ``Bottleneck`` module at the same shape;
4. the two-stage SpecPredictor at full ResNet-50 width (random weights
   from fixed seeds, synthetic SMPL) on 720x1280 frames, in fp32 and
   bf16, plus a camcalib_every=3 stream; checks shapes, finiteness and
   that the predictor went through K1;
5. the e2e pipeline (``spec_tpu_torch.pipeline.build_pipeline``) at full
   ResNet-50 width on 16 frames of 512x672, one person each, in bf16 and
   fp32, with the module stage-1 trunk and the folded-BN fused trunk:
   shapes, finiteness, K3 and K1 launch counts, wall ms per call; each
   trunk's feature map held to the fp32 module trunk's (relative L2
   error), fused vs module angles in fp32, the angles' spread over the
   frames;
6. K1 against its plain PyTorch version on the card (synthetic SMPL,
   V = 6890, 1e-5 m budget) at several batch sizes, among them the
   batches phases 4 and 5 gave it, timed with CUDA events;
7. K2 projects the fp32 fused pipeline's meshes (16 x 6890 vertices) with
   its cameras, against its plain version and
   ``geometry.perspective_projection`` (0.01 px budget), timed;
8. small models on the card and on the CPU must agree: the predictor
   (ResNet-18) and the pipelines (ResNet-50, 64x96 frames; both trunks
   in fp32 and the fused trunk in bf16, where the CPU runs K3's plain
   version);
9. prints the kernels line and, last, ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` runs phases 1-2 and then, instead of
the rest, profiles phase 4's predictor (wall medians per stage, device
busy time, idle share and the top device operations, fp32 and bf16) and
phase 5's pipeline with each stage-1 trunk.

Needs no network and no files beyond the checkout; builds go to
``build/spec_tpu_torch/``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LBS_BATCHES = (1, 3, 8, 32)
LBS_BUDGET = 1e-5          # m, the fused kernel's budget vs fp32
FRAME_HW = (720, 1280)
PERSONS_PER_FRAME = (1, 2, 3, 2)
BATCH_SIZE = 32
KERNELS = ('lbs', 'bottleneck', 'projection')
# The pipeline's input: bench.py's default stage-1 bucket, 16 frames.
PIPE_FRAMES, PIPE_HW = 16, (512, 672)
# ResNet-50 identity blocks on PIPE_HW: (H, W, C, M, blocks in the stage).
RESNET50_STAGES = ((128, 168, 256, 64, 2), (64, 84, 512, 128, 3),
                   (32, 42, 1024, 256, 5), (16, 21, 2048, 512, 2))
ODD_SHAPE = (2, 13, 11, 256, 64, 3)       # B, H, W, C, M, chain length
# K3 budgets, relative to max(1, max |plain|): exact fp32 on both sides;
# bf16 about two bf16 steps at the largest value (sums that land near a
# rounding boundary of h1, h2 or y round the other way on one side).
K3_BUDGET = {'fp32': 1e-4, 'bf16': 2.0 ** -6}
K2_BUDGET = 1e-2           # px (TPU_CHECKS_r05.json)
# Fused vs module stage-1 angles (rad) in fp32: only the BN fold and the
# summation order differ.
ANGLE_BUDGET_FP32 = 1e-4
# Stage-1 feature maps against the fp32 module trunk's, relative L2
# error: fp32 (fold and order only); bf16, the budget the CPU tests hold
# the bf16 FusedResNet to against the JAX trunk (each bf16 trunk is
# about 1e-2 from fp32 there).
FEATURE_BUDGET = {'fp32': 1e-4, 'bf16': 2e-2}


def _time_ms(fn, n=50, warmup=5, flush=None):
    """Median device time of ``fn()`` over ``n`` calls (CUDA events),
    with the L2 cache flushed before each call when ``flush`` is given
    (in the pipeline the ResNet runs between SMPL calls)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)} count '
          f'{torch.cuda.device_count()}')
    return smi


def phase_build():
    from spec_tpu_torch.ops.cuda_build import build_libraries

    t0 = time.perf_counter()
    built = build_libraries(KERNELS)
    print(f'[build] {len(KERNELS)} kernels in parallel: '
          f'{time.perf_counter() - t0:.2f} s wall')
    for name, (path, log, seconds) in built.items():
        print(f'[build] {path.name} in {seconds:.2f} s')
        for ln in log.splitlines():
            if 'registers' in ln or 'spill' in ln:
                print(f'[build] {name}: {ln.strip()}')


def _lbs_operands(packed, assets, B, seed):
    import numpy as np
    import torch

    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.core.geometry import rodrigues
    from spec_tpu_torch.ops.lbs import lbs_coeffs

    rng = np.random.RandomState(seed)
    dev = packed.dirs.device
    betas = torch.from_numpy(rng.randn(B, 10).astype('f4') * 0.5).to(dev)
    rot = rodrigues(torch.from_numpy(
        rng.randn(B, 24, 3).astype('f4') * 0.4).to(dev))
    joints_rest = packed.joints_template[None] + (
        betas @ packed.shapedirs_j).reshape(B, 24, 3)
    world = S._rigid_transform_chain(rot, joints_rest, assets.parents)
    rel_tf = S._rest_corrected(world, joints_rest)[..., :3, :].contiguous()
    return lbs_coeffs(betas, rot), rel_tf


def phase_lbs(batches):
    """K1 vs its plain version at ``batches`` (rows of SMPL), timed."""
    import torch

    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.utils.precision import fp32_precision

    assets = S.create_test_assets().to('cuda')
    packed = L.pack_lbs_operands(assets).to('cuda')
    flush = torch.empty(64 * 2 ** 20 // 4, device='cuda')
    rows = {}
    with fp32_precision(), torch.inference_mode():
        for B in batches:
            coeffs, rel_tf = _lbs_operands(packed, assets, B, seed=B)
            before = L.LAUNCHES
            out = L.fused_lbs_vertices(packed, coeffs, rel_tf)
            torch.cuda.synchronize()
            if L.LAUNCHES != before + 1:
                raise RuntimeError('the LBS wrapper did not count its launch')
            ref = L.fused_lbs_vertices_plain(packed, coeffs, rel_tf)
            err = (out - ref).abs().max().item()
            if not (out.shape == (B, 6890, 3) and err <= LBS_BUDGET):
                raise RuntimeError(f'LBS kernel disagrees at B={B}: '
                                   f'shape {tuple(out.shape)}, max abs err '
                                   f'{err:.3e} > {LBS_BUDGET:.0e}')
            ms = _time_ms(lambda: L.fused_lbs_vertices(packed, coeffs,
                                                       rel_tf), flush=flush)
            plain_ms = _time_ms(lambda: L.fused_lbs_vertices_plain(
                packed, coeffs, rel_tf), flush=flush)
            rows[B] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            print(f'[lbs] B={B} V=6890 max_abs_err={err:.3e} m '
                  f'kernel={ms:.4f} ms plain={plain_ms:.4f} ms '
                  '(median of 50, L2 flushed)')
    return rows


def phase_bottleneck():
    """K3 vs its plain version at the pipeline's identity-block shapes,
    and the time of one block: kernel, plain version, cuDNN module."""
    import torch

    from spec_tpu_torch.models.backbones.resnet import Bottleneck
    from spec_tpu_torch.ops import bottleneck as TB
    from spec_tpu_torch.utils.precision import fp32_precision

    # The card tests' operands (tests/ is put on sys.path by main).
    from test_torch_cuda_bottleneck import random_chain

    rows = {}
    shapes = [(PIPE_FRAMES, H, W, C, M, 1)
              for H, W, C, M, _ in RESNET50_STAGES] + [ODD_SHAPE]
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for si, (B, H, W, C, M, k) in enumerate(shapes):
            x, ws = random_chain(B, H, W, C, M, k, seed=si, dtype=dtype,
                                 device='cuda')
            before = TB.LAUNCHES
            with torch.inference_mode():
                out = TB.fused_bottleneck_chain(x, ws)
                torch.cuda.synchronize()
                if TB.LAUNCHES != before + k:
                    raise RuntimeError('the bottleneck wrapper did not '
                                       'count its launches')
                ref = TB.fused_bottleneck_chain_plain(x, ws)
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            if not (out.shape == x.shape and out.dtype == dtype
                    and err <= K3_BUDGET[tag] * scale):
                raise RuntimeError(
                    f'K3 disagrees at {tag} {(B, H, W, C, M)} k={k}: '
                    f'max abs err {err:.3e} > {K3_BUDGET[tag]:.1e} x '
                    f'{scale:.3f}')
            row = dict(max_abs_err=err, scale=scale)
            line = (f'[bottleneck {tag}] B={B} {H}x{W} C={C} M={M} k={k}: '
                    f'max_abs_err={err:.3e} (budget {K3_BUDGET[tag]:.1e} x '
                    f'{scale:.3f})')
            if k == 1:
                blk = Bottleneck(C, M).to('cuda').eval().to(
                    dtype=dtype, memory_format=torch.channels_last)
                nchw = x.permute(0, 3, 1, 2)
                with torch.inference_mode(), fp32_precision():
                    row['ms'] = _time_ms(
                        lambda: TB.fused_bottleneck_chain(x, ws), n=10,
                        warmup=2)
                    row['plain_ms'] = _time_ms(
                        lambda: TB.fused_bottleneck_chain_plain(x, ws),
                        n=10, warmup=2)
                    row['cudnn_ms'] = _time_ms(lambda: blk(nchw), n=10,
                                               warmup=2)
                line += (f' kernel={row["ms"]:.4f} ms plain='
                         f'{row["plain_ms"]:.4f} ms cudnn_block='
                         f'{row["cudnn_ms"]:.4f} ms (median of 10)')
                del blk
            rows[tag, si] = row
            print(line, flush=True)
            del x, ws, out, ref
        torch.cuda.empty_cache()
    return rows


def _frames_and_boxes(n_frames, persons, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    frames, boxes = [], []
    for i in range(n_frames):
        # smooth gradients plus noise: a frame with some structure
        yy, xx = np.mgrid[:h, :w].astype(np.float32)
        base = 110 + 60 * np.sin(xx / (90 + 7 * i)) * np.cos(yy / 70)
        img = base[..., None] + rng.randn(h, w, 3) * 20
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        k = persons[i % len(persons)]
        bw = rng.uniform(150, 300, k)
        boxes.append(np.stack([rng.uniform(200, w - 200, k),
                               rng.uniform(200, h - 200, k), bw,
                               bw * rng.uniform(1.2, 2.0, k)],
                              1).astype(np.float32))
    return frames, boxes


def _check_results(results, n_persons):
    import numpy as np

    shapes = {'smpl_vertices': (6890, 3), 'smpl_joints3d': (49, 3),
              'smpl_joints2d': (49, 2), 'pred_cam_t': (3,)}
    people = [p for r in results for p in r]
    if len(people) != n_persons:
        raise RuntimeError(f'{len(people)} results for {n_persons} boxes')
    for p in people:
        for k, shape in shapes.items():
            if p[k].shape != shape:
                raise RuntimeError(f'{k} has shape {p[k].shape}, '
                                   f'expected {shape}')
        for k, v in p.items():
            if k != 'camera' and not np.isfinite(v).all():
                raise RuntimeError(f'non-finite values in {k}')


def _full_width_predictor(dtype):
    """The two-stage predictor at full ResNet-50 width on the card."""
    from spec_tpu_torch.serving import SpecPredictor

    return SpecPredictor(
        device='cuda', backbone='resnet50', camcalib_backbone='resnet50',
        use_cam_feats=True, img_res=224, min_size=600,
        batch_size=BATCH_SIZE, dtype=dtype)


def phase_predictor():
    import numpy as np
    import torch

    from spec_tpu_torch.ops import lbs as L

    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    n_persons = sum(len(b) for b in boxes)
    out = {'persons': n_persons}
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        pred = _full_width_predictor(dtype)
        L.LAUNCHES = 0
        results = pred.predict(frames, boxes)          # warm-up
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = pred.predict(frames, boxes)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = L.LAUNCHES
        if launches < 3:
            raise RuntimeError(f'{tag} predict launched the LBS kernel '
                               f'{launches} times in 3 calls')
        _check_results(results, n_persons)
        ms = statistics.mean(times)
        out[tag] = dict(ms=ms, launches=launches, results=results)
        print(f'[predict {tag}] resnet50 x2, 4 frames {FRAME_HW[0]}x'
              f'{FRAME_HW[1]}, {n_persons} persons: '
              f'{" ".join(f"{t:.2f}" for t in times)} ms per call, '
              f'{ms:.2f} ms mean, {n_persons / ms * 1e3:.1f} persons/s, '
              f'LBS kernel launches {launches}')
        if tag == 'fp32':
            stream_frames, stream_boxes = _frames_and_boxes(6, (1,), seed=1)
            pred.camcalib_every = 3
            pred.cut_threshold = 0.0     # pure stride: keyframes 0 and 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, cams = pred.predict(stream_frames, stream_boxes,
                                     stream='smoke', return_cameras=True)
            stream_ms = (time.perf_counter() - t0) * 1e3
            _check_results(res, 6)
            if not (cams[1] == cams[0] and cams[4] == cams[3]
                    and cams[3] != cams[0]):
                raise RuntimeError('camcalib_every=3 did not reuse the '
                                   'keyframe cameras')
            print(f'[predict fp32 camcalib_every=3] 6 frames, 6 persons: '
                  f'{stream_ms:.2f} ms (first call of the stream)')
        del pred
        torch.cuda.empty_cache()
    dv = max(np.abs(a['smpl_vertices'] - b['smpl_vertices']).max()
             for ra, rb in zip(out['fp32']['results'], out['bf16']['results'])
             for a, b in zip(ra, rb))
    print(f'[predict] bf16 vs fp32 max |vertex diff| {dv:.3e} m '
          '(random weights)')
    return out


def _wall_ms(fn, n):
    """Median host-clock ms of ``fn()`` over ``n`` calls, each bracketed
    by device synchronization, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_profile(label, fn, call_ms, n_prof, top):
    """torch.profiler over ``n_prof`` calls of ``fn``: prints the device
    busy time per call (union of the kernel and copy intervals), the
    device operations per call, the idle share (1 - busy per call /
    ``call_ms``, the unprofiled call median) and the ``top`` device
    operations by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        raise RuntimeError('the profiler saw no device operations')
    busy_us, end = 0.0, float('-inf')
    by_name: dict = {}
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    busy = busy_us / 1e3 / n_prof
    print(f'[profile {label}] device busy {busy:.3f} ms per call; '
          f'{len(dev) / n_prof:.0f} device ops per call; idle share '
          f'{1.0 - busy / call_ms:.3f}')
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f'[profile {label}]   {us / 1e3 / n_prof:8.3f} ms per call '
              f'({us / total:6.1%})  {name[:110]}')


def phase_profile(n_wall=10, n_prof=3, top=8):
    """Where the time goes, in fp32 and bf16: (a) one ``predict`` call at
    phase 4's input, with the wall medians of the call, of stage 1 alone
    (``estimate_cameras``) and of stage 2 alone (``predict`` with the
    cameras given); (b) one call of phase 5's pipeline with each stage-1
    trunk. Each is followed by :func:`_device_profile`."""
    import torch

    from spec_tpu_torch.pipeline import build_pipeline

    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        pred = _full_width_predictor(dtype)
        cams = pred.estimate_cameras(frames)
        call = _wall_ms(lambda: pred.predict(frames, boxes), n_wall)
        stage1 = _wall_ms(lambda: pred.estimate_cameras(frames), n_wall)
        stage2 = _wall_ms(lambda: pred.predict(frames, boxes, cameras=cams),
                          n_wall)
        print(f'[profile {tag}] predict median of {n_wall} {call:.3f} ms; '
              f'stage 1 alone {stage1:.3f} ms; stage 2 alone {stage2:.3f} '
              'ms')
        _device_profile(tag, lambda: pred.predict(frames, boxes), call,
                        n_prof, top)
        del pred
        torch.cuda.empty_cache()
    args = _pipeline_inputs(PIPE_FRAMES, PIPE_HW, seed=0, device='cuda')
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for stage1 in ('module', 'fused'):
            *_, pipeline = build_pipeline(compute_dtype=dtype,
                                          stage1=stage1, device='cuda')
            call = _wall_ms(lambda: pipeline(*args), n_wall)
            label = f'pipeline {tag} {stage1}'
            print(f'[profile {label}] call median of {n_wall} {call:.3f} ms')
            _device_profile(label, lambda: pipeline(*args), call, n_prof,
                            top)
            del pipeline
            torch.cuda.empty_cache()


def phase_card_vs_cpu():
    import numpy as np

    from spec_tpu_torch.serving import SpecPredictor

    rng = np.random.RandomState(11)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)
              for _ in range(3)]
    boxes = [np.zeros((0, 4), np.float32),
             np.array([[40.0, 55.0, 50.0, 50.0]], np.float32),
             np.array([[60.0, 50.0, 40.0, 70.0], [90.0, 40.0, 30.0, 55.0],
                       [120.0, 10.0, 45.0, 60.0]], np.float32)]
    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              use_cam_feats=True, min_size=96, img_res=64, batch_size=8)
    res_g, cams_g = SpecPredictor(device='cuda', **kw).predict(
        frames, boxes, return_cameras=True)
    res_c, cams_c = SpecPredictor(device='cpu', **kw).predict(
        frames, boxes, return_cameras=True)
    cam_err = max(abs(g[k] - c[k]) for g, c in zip(cams_g, cams_c)
                  for k in ('vfov', 'pitch', 'roll'))
    f_err = max(abs(g['f_pix'] - c['f_pix']) for g, c in zip(cams_g, cams_c))
    errs = {k: 0.0 for k in ('pred_pose', 'pred_shape', 'pred_cam',
                             'pred_cam_t', 'smpl_vertices', 'smpl_joints3d',
                             'smpl_joints2d')}
    for rg, rc in zip(res_g, res_c):
        for pg, pc in zip(rg, rc):
            for k in errs:
                errs[k] = max(errs[k], float(np.abs(pg[k] - pc[k]).max()))
    limits = dict(pred_pose=2e-3, pred_shape=2e-3, pred_cam=2e-3,
                  pred_cam_t=2e-3, smpl_vertices=5e-3, smpl_joints3d=5e-3,
                  smpl_joints2d=0.1)
    print(f'[card vs cpu] resnet18 min_size 96 img_res 64: camera angles '
          f'{cam_err:.2e} rad (limit 1e-4), f_pix {f_err:.2e} px '
          '(limit 0.05), ' + ', '.join(f'{k} {v:.2e} (limit {limits[k]})'
                                        for k, v in errs.items()))
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if cam_err > 1e-4 or f_err > 0.05 or bad:
        raise RuntimeError(f'card and CPU disagree: {bad or "cameras"}')


def _pipeline_inputs(B, hw, seed, device):
    """Frames in [0, 255] and one person box per frame, as bench.py draws
    them (its 512x672 ranges, scaled to ``hw``)."""
    import numpy as np
    import torch

    from spec_tpu_torch.ops.preprocess import spin_crop_corners

    rng = np.random.RandomState(seed)
    h, w = hw
    raw = (rng.rand(B, h, w, 3) * 255).astype('f4')
    center = ((rng.rand(B, 2) * [0.45, 0.6] + [0.27, 0.2])
              * [w, h]).astype('f4')
    scale = ((rng.rand(B) * 0.8 + 0.8) * h / 512).astype('f4')
    corners = spin_crop_corners(center, scale)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (raw, corners, center, scale))


def _check_pipeline(outs, B):
    import torch

    shapes = ((B, 6890, 3), (B, 49, 2), (B, 3), (B,), (B,), (B,))
    for o, shape in zip(outs, shapes):
        if tuple(o.shape) != shape or o.dtype != torch.float32:
            raise RuntimeError(f'pipeline output {tuple(o.shape)} '
                               f'{o.dtype}, expected {shape} float32')
        if not torch.isfinite(o).all():
            raise RuntimeError('non-finite pipeline output')


def _stage1_features(camcalib, stage1, dtype, raw_frames):
    """The stage-1 trunk's NHWC feature map, as float32, on the frames the
    pipeline normalizes: the CamCalib module's backbone, or the
    FusedResNet that ``build_pipeline(stage1='fused')`` builds over it."""
    import torch

    from spec_tpu_torch.models.backbones.fused_resnet import FusedResNet
    from spec_tpu_torch.ops.preprocess import normalize_image
    from spec_tpu_torch.utils.precision import compute_dtype

    with torch.inference_mode():
        frames = normalize_image(raw_frames / 255.0)
        if stage1 == 'fused':
            return FusedResNet(camcalib.backbone, dtype=dtype)(frames).float()
        with compute_dtype(dtype, frames.device.type):
            return camcalib.backbone(frames.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1).float()


def _rel_err(a, b):
    return ((a - b).norm() / b.norm()).item()


def phase_pipeline():
    """The e2e pipeline at full ResNet-50 width, both stage-1 trunks."""
    import torch

    from spec_tpu_torch.ops import bottleneck as TB
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.pipeline import build_pipeline

    args = _pipeline_inputs(PIPE_FRAMES, PIPE_HW, seed=0, device='cuda')
    out, ref_feats = {}, None
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        res = {}
        for stage1 in ('module', 'fused'):
            camcalib, *_, pipeline = build_pipeline(
                compute_dtype=dtype, stage1=stage1, device='cuda')
            pipeline(*args)                                  # warm-up
            torch.cuda.synchronize()
            TB.LAUNCHES = L.LAUNCHES = 0
            outs = pipeline(*args)
            torch.cuda.synchronize()
            launches = {'K3': TB.LAUNCHES, 'K1': L.LAUNCHES}
            _check_pipeline(outs, PIPE_FRAMES)
            want_k3 = stage1 == 'fused'
            if launches['K1'] < 1 or (launches['K3'] > 0) != want_k3:
                raise RuntimeError(f'{tag} {stage1} pipeline launches '
                                   f'{launches}')
            ms = _wall_ms(lambda: pipeline(*args), 5)
            feats = _stage1_features(camcalib, stage1, dtype, args[0])
            if ref_feats is None:                    # the fp32 module trunk
                ref_feats = feats
                live = (feats > 0).float().mean().item()
                if live < 0.3:
                    raise RuntimeError(f'stage-1 features {live:.3f} live')
            feat_err = _rel_err(feats, ref_feats)
            res[stage1] = dict(outs=outs, launches=launches, ms=ms,
                               feat_err=feat_err)
            print(f'[pipeline {tag} {stage1}] resnet50 x2, '
                  f'{PIPE_FRAMES} frames {PIPE_HW[0]}x{PIPE_HW[1]}, one '
                  f'person each: {ms:.3f} ms per call (median of 5), '
                  f'{PIPE_FRAMES / ms * 1e3:.1f} frames/s; launches in '
                  f'one call {launches}; stage-1 features vs the fp32 '
                  f'module trunk: relative L2 error {feat_err:.3e} (budget '
                  f'{FEATURE_BUDGET[tag]:.0e})', flush=True)
            if not feat_err <= FEATURE_BUDGET[tag]:
                raise RuntimeError(f'{tag} {stage1} stage-1 features '
                                   'disagree with the fp32 module trunk')
            del camcalib, pipeline, feats
            torch.cuda.empty_cache()
        out[tag] = res

    def angle_err(a, b):
        return max((x - y).abs().max().item()
                   for x, y in zip(a['outs'][3:], b['outs'][3:]))

    ref = out['fp32']['module']
    spread = [(a.max() - a.min()).item() for a in ref['outs'][3:]]
    fp32_err = angle_err(out['fp32']['fused'], ref)
    print(f'[pipeline] stage-1 angles: spread over the {PIPE_FRAMES} frames '
          '(fp32 module trunk; vfov, pitch, roll) '
          f'{", ".join(f"{v:.3e}" for v in spread)} rad; fp32 fused vs '
          f'module {fp32_err:.3e} rad (budget {ANGLE_BUDGET_FP32:.0e}); to '
          f'the fp32 module trunk, bf16 module '
          f'{angle_err(out["bf16"]["module"], ref):.3e} rad, bf16 fused '
          f'{angle_err(out["bf16"]["fused"], ref):.3e} rad, bf16 fused vs '
          f'bf16 module '
          f'{angle_err(out["bf16"]["fused"], out["bf16"]["module"]):.3e} rad '
          '(bf16 is held by its features, above, and card vs CPU)')
    if fp32_err > ANGLE_BUDGET_FP32:
        raise RuntimeError('fused and module stage-1 angles disagree')
    return out


def phase_projection(pipe):
    """K2 on the fp32 fused pipeline's meshes and cameras."""
    import torch

    from spec_tpu_torch.core import geometry as G
    from spec_tpu_torch.ops import projection as TP
    from spec_tpu_torch.utils.precision import fp32_precision

    verts, _, cam_t, vfov, pitch, roll = pipe['fp32']['fused']['outs']
    B = verts.shape[0]
    h, w = (torch.full((B,), float(v), device='cuda') for v in PIPE_HW)
    with fp32_precision():
        R = G.euler_to_rotmat(
            torch.stack([pitch, torch.zeros_like(pitch), roll], -1))
        K = G.build_cam_intrinsics(G.focal_length_from_vfov(vfov, h), w, h)
    args = (verts.contiguous(), R, cam_t, K)
    TP.LAUNCHES = 0
    pix = TP.project_points(*args)
    torch.cuda.synchronize()
    launches = TP.LAUNCHES
    if launches != 1:
        raise RuntimeError(f'project_points launched {launches} times')
    plain = TP.project_points_plain(*args)
    ref = G.perspective_projection(*args)
    err = max((pix - plain).abs().max().item(),
              (pix - ref).abs().max().item())
    if not (pix.shape == (B, 6890, 2) and torch.isfinite(pix).all()
            and err <= K2_BUDGET):
        raise RuntimeError(f'K2 disagrees: max abs err {err:.3e} px')
    flush = torch.empty(64 * 2 ** 20 // 4, device='cuda')
    ms = _time_ms(lambda: TP.project_points(*args), flush=flush)
    plain_ms = _time_ms(lambda: TP.project_points_plain(*args), flush=flush)
    print(f'[projection] B={B} V=6890 max_abs_err={err:.3e} px vs plain and '
          f'perspective_projection (budget {K2_BUDGET}); kernel={ms:.4f} ms '
          f'plain={plain_ms:.4f} ms (median of 50, L2 flushed)')
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


# Card vs CPU, 2 frames of 64x96: limits on (vertices m, joints2d px,
# cam_t, vfov, pitch, roll rad, stage-1 features relative L2). In bf16
# both sides round at the same points but sum in another order (and the
# CPU's bf16 convolutions are not cuDNN's), so the roundings differ as
# between any two bf16 trunks: the features get FEATURE_BUDGET's bf16
# budget.
CARD_VS_CPU = {
    'fp32': (5e-3, 0.1, 2e-3, 1e-4, 1e-4, 1e-4, FEATURE_BUDGET['fp32']),
    'bf16': (1e-2, 0.5, 1e-2, 1e-3, 1e-3, 1e-3, FEATURE_BUDGET['bf16']),
}


def phase_pipeline_card_vs_cpu():
    """The pipelines (random weights from the same seeds) on the card and
    on the CPU, 2 frames of 64x96: both trunks in fp32 and the fused
    trunk in bf16, so card-side K3 (both dtypes) and K1 meet the CPU's
    plain versions; the stage-1 feature maps are compared too."""
    import numpy as np
    import torch

    from spec_tpu_torch.pipeline import build_pipeline

    names = ('vertices', 'joints2d', 'cam_t', 'vfov', 'pitch', 'roll',
             'features')
    for stage1, tag, dtype in (('module', 'fp32', torch.float32),
                               ('fused', 'fp32', torch.float32),
                               ('fused', 'bf16', torch.bfloat16)):
        got, feats = {}, {}
        for dev in ('cuda', 'cpu'):
            camcalib, *_, pipeline = build_pipeline(
                compute_dtype=dtype, img_res=64, stage1=stage1, device=dev)
            args = _pipeline_inputs(2, (64, 96), seed=1, device=dev)
            got[dev] = [o.cpu().numpy() for o in pipeline(*args)]
            feats[dev] = _stage1_features(camcalib, stage1, dtype,
                                          args[0]).cpu()
        errs = [float(np.abs(a - b).max())
                for a, b in zip(got['cuda'], got['cpu'])]
        errs.append(_rel_err(feats['cuda'], feats['cpu']))
        limits = CARD_VS_CPU[tag]
        print(f'[card vs cpu] pipeline {stage1} {tag} resnet50 64x96: ' +
              ', '.join(f'{n} {e:.2e} (limit {lim})'
                        for n, e, lim in zip(names, errs, limits)))
        bad = [n for n, e, lim in zip(names, errs, limits) if not e <= lim]
        if bad:
            raise RuntimeError(f'{stage1} {tag} pipeline: card and CPU '
                               f'disagree in {bad}')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this check '
              'runs only on an NVIDIA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.append(str(ROOT / 'tests'))     # a card test's helper
    if not (ROOT / 'spec_tpu_torch' / '__init__.py').exists():
        print('chip_smoke: run from the root of a spec-tpu checkout '
              '(spec_tpu_torch/ not found beside this script)',
              file=sys.stderr)
        return 2
    # Synthetic SMPL assets and random weights: point the asset registry
    # at a directory that does not exist inside the checkout.
    os.environ['SPEC_DATA_ROOT'] = str(ROOT / 'build' / 'spec_tpu_torch'
                                       / 'no_assets')

    phase_device()
    phase_build()
    if '--profile' in sys.argv[1:]:
        phase_profile()
        return 0
    from spec_tpu_torch.utils.batching import pad_pow2

    k3_rows = phase_bottleneck()
    pred = phase_predictor()
    pipe = phase_pipeline()
    # K1 at the batches the two paths gave it: the predictor's one padded
    # stage-2 chunk, and the pipeline's rows of SMPL (K1 wrote its
    # vertices).
    main_batch = pad_pow2(min(sum(PERSONS_PER_FRAME), BATCH_SIZE),
                          BATCH_SIZE)
    pipe_batch = pipe['bf16']['fused']['outs'][0].shape[0]
    lbs_rows = phase_lbs(sorted(set(LBS_BATCHES)
                                | {main_batch, pipe_batch}))
    k2 = phase_projection(pipe)
    phase_card_vs_cpu()
    phase_pipeline_card_vs_cpu()

    row = lbs_rows[main_batch]
    k3 = k3_rows['bf16', 0]     # layer1's block at the pipeline's dtype
    print(json.dumps({'kernels': [{
        'name': 'fused_lbs_vertices',
        'route': 'cuda',
        'source': 'spec_tpu_torch/csrc/lbs.cu',
        'replaces': 'spec_tpu/ops/pallas/lbs.py:97',
        'launches': pred['fp32']['launches'],
        'max_abs_err': max(r['max_abs_err'] for r in lbs_rows.values()),
        'ms': row['ms'],
        'plain_ms': row['plain_ms'],
    }, {
        'name': 'fused_bottleneck_chain',
        'route': 'cuda',
        'source': 'spec_tpu_torch/csrc/bottleneck.cu',
        'replaces': 'spec_tpu/ops/pallas/bottleneck.py:92',
        'launches': pipe['bf16']['fused']['launches']['K3'],
        'max_abs_err': max(r['max_abs_err'] for r in k3_rows.values()),
        'ms': k3['ms'],
        'plain_ms': k3['plain_ms'],
    }, {
        'name': 'project_points',
        'route': 'cuda',
        'source': 'spec_tpu_torch/csrc/projection.cu',
        'replaces': 'spec_tpu/ops/pallas/projection.py:39',
        'launches': k2['launches'],
        'max_abs_err': k2['max_abs_err'],
        'ms': k2['ms'],
        'plain_ms': k2['plain_ms'],
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
