#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spec_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its own results; any failure raises and exits nonzero:

1. device: CUDA must be available (there is no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the fused LBS kernel from ``spec_tpu_torch/csrc/``;
3. the kernel against its plain PyTorch version on the card (synthetic
   SMPL, V = 6890, several batch sizes, 1e-5 m budget), timed with CUDA
   events;
4. the full two-stage SpecPredictor at full ResNet-50 width (random
   weights from fixed seeds, synthetic SMPL) on 720x1280 frames, in fp32
   and bf16, plus a camcalib_every=3 stream; checks shapes, finiteness
   and that the predictor went through the kernel;
5. the same small predictor on the card and on the CPU must agree;
6. prints the kernels line and, last, ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` runs phases 1-2 and then, instead of
the rest, profiles phase 4's predictor (wall medians per stage, device
busy time, idle share and the top device operations, fp32 and bf16).

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
    from spec_tpu_torch.ops.cuda_build import build_library

    path, log, seconds = build_library('lbs')
    ptxas = [ln.strip() for ln in log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    print(f'[build] {path.name} in {seconds:.2f} s')
    for ln in ptxas:
        print(f'[build] {ln}')
    return seconds


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


def phase_lbs(main_batch):
    import torch

    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.utils.precision import fp32_precision

    assets = S.create_test_assets().to('cuda')
    packed = L.pack_lbs_operands(assets).to('cuda')
    flush = torch.empty(64 * 2 ** 20 // 4, device='cuda')
    rows = {}
    with fp32_precision(), torch.inference_mode():
        for B in sorted(set(LBS_BATCHES) | {main_batch}):
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


def phase_profile(n_wall=10, n_prof=3, top=8):
    """Where the time of one ``predict`` call goes, at phase 4's input, in
    fp32 and bf16. Per dtype, prints the wall medians of the call, of
    stage 1 alone (``estimate_cameras``) and of stage 2 alone (``predict``
    with the cameras given); then, from torch.profiler over ``n_prof``
    calls, the device busy time per call (union of the kernel and copy
    intervals), the device operations per call, the idle share
    (1 - busy per call / unprofiled call median) and the ``top`` device
    operations by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        pred = _full_width_predictor(dtype)
        cams = pred.estimate_cameras(frames)
        call = _wall_ms(lambda: pred.predict(frames, boxes), n_wall)
        stage1 = _wall_ms(lambda: pred.estimate_cameras(frames), n_wall)
        stage2 = _wall_ms(lambda: pred.predict(frames, boxes, cameras=cams),
                          n_wall)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                pred.predict(frames, boxes)
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
        print(f'[profile {tag}] predict median of {n_wall} {call:.3f} ms; '
              f'stage 1 alone {stage1:.3f} ms; stage 2 alone {stage2:.3f} '
              f'ms; device busy {busy:.3f} ms per call; '
              f'{len(dev) / n_prof:.0f} device ops per call; idle share '
              f'{1.0 - busy / call:.3f}')
        total = sum(by_name.values())
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            print(f'[profile {tag}]   {us / 1e3 / n_prof:8.3f} ms per call '
                  f'({us / total:6.1%})  {name[:110]}')
        del pred
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this check '
              'runs only on an NVIDIA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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

    # The SMPL batch predict launches K1 with: one padded stage-2 chunk.
    main_batch = pad_pow2(min(sum(PERSONS_PER_FRAME), BATCH_SIZE),
                          BATCH_SIZE)
    lbs_rows = phase_lbs(main_batch)
    pred = phase_predictor()
    phase_card_vs_cpu()

    row = lbs_rows[main_batch]
    print(json.dumps({'kernels': [{
        'name': 'fused_lbs_vertices',
        'route': 'cuda',
        'source': 'spec_tpu_torch/csrc/lbs.cu',
        'replaces': 'spec_tpu/ops/pallas/lbs.py:97',
        'launches': pred['fp32']['launches'],
        'max_abs_err': max(r['max_abs_err'] for r in lbs_rows.values()),
        'ms': row['ms'],
        'plain_ms': row['plain_ms'],
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
