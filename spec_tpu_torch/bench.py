"""The port's benchmark: ``python -m spec_tpu_torch.bench``.

The counterpart of ``bench.py``'s ``pipeline``, ``serving``,
``latency``, ``eval``, ``train`` and ``detect`` modes (argument names
and defaults from there; ``--stage1 flax`` is ``module`` here, and
``--dtype`` picks the compute dtype):

* ``pipeline`` (default): ``pipeline.build_pipeline`` on B = 128 raw
  frames of 512x672 in device memory, one person per frame: img/s per
  GPU, timed by CUDA events over windows of ``--iters`` calls.
* ``serving``: ``SpecPredictor.predict`` on ``--frames`` 480x640 frames
  with ``--persons`` boxes each (``batch_size`` 32, ``--min_size``,
  ``--camcalib_every``): persons/s and ms per call by the host clock
  (``predict`` fetches its results to the host). ``--compute_only``
  replays the predictor's stage graphs on inputs staged on the device
  (the reference's jitted stage bodies on staged inputs), by CUDA
  events. ``--detector`` also builds the predictor's YOLOv3 (random
  init) and times ``predict(frames)`` without boxes, which queues
  detection and stage 1 before fetching either (overlapped), against
  ``detector.detect`` fetched first and then ``predict(frames, boxes)``
  (sequential): ms per frame each way.
* ``latency``: ``predict`` on one 480x640 frame with one box: e2e ms per
  call, and stage-1 and stage-2 ms from replays on staged inputs.
* ``eval``: the eval step (``eval/eval_loop.make_eval_step``) at
  ``bench.py``'s ``eval_bench`` inputs: B = 128 crops of 224², HMR with
  ``--backbone`` (ResNet-50) and camera features, GT SMPL gendered over
  three synthetic asset sets (V = 6890), J14 Procrustes, J24 and V2V:
  img/s by the host clock (the step's Procrustes tail reads back on the
  host).
* ``detect``: the YOLOv3 person detector (``models/detector.py``) at
  ``bench.py``'s ``detect_bench`` setup: B = 32 (``--batch``) inputs of
  416² (``--frame_h``) in device memory, bf16, the forward and the
  device-side top-K person filter, one graph replay per call (random
  init from seed 0): img/s and ms per batch by CUDA events; the (B,
  256, 5) candidates stay on the device.
* ``train``: the SPEC train step (``train/steps.make_spec_train_step``:
  forward, GT and predicted SMPL through K1, ``hmr_cam_loss``, backward
  with K1's closed-form VJP, Adam 1e-4 in place) at ``bench.py``'s
  ``train_bench`` setup: B = 64 crops of 224² (``--batch``), ResNet-50
  HMR with camera features, bf16, synthetic SMPL (V = 6890), zeroed head
  decoders, its batch drawn in its order. One CUDA graph replay per
  step; ``--eager`` runs the step's eager body instead; ``--remat``
  checkpoints the backbone's blocks (TRAINING.REMAT). img/s and ms per
  step by the host clock (each window ends with a sync); ``--profile``
  adds K1's own device time per step.

Every mode warms up first (the graph captures included) and times
``WINDOWS`` windows; the last line is one JSON object with ``metric``,
``value`` (the median window), ``unit``, ``spread`` (min and max over the
windows), ``device`` and ``card`` (the card's name and power limit, as
nvidia-smi gives them). ``--profile`` prints, on an earlier line, the
device busy time per call, the idle share, the device operations and the
host's launch calls per call (torch.profiler).

Weights are random (fixed seeds) and SMPL synthetic. The default device
is ``cuda``: without a card the bench exits non-zero; ``--device cpu``
runs it on the CPU (tests, at tiny sizes), where times are host times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WINDOWS = 10
# Frame sizes per mode when --frame_h/--frame_w are not given: the
# pipeline's stage-1 bucket, and the serving and latency frames.
FRAME_HW = {'pipeline': (512, 672), 'serving': (480, 640),
            'latency': (480, 640), 'eval': (224, 224), 'train': (224, 224),
            'detect': (416, 416)}
# bench.py's batch per mode (128 unless named).
BATCH = {'train': 64, 'detect': 32}
# CUDA runtime calls that put work on the device, as the profiler names
# them: what the host issues per call.
_LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                 'cuLaunchKernelEx', 'cudaMemcpyAsync', 'cudaMemsetAsync',
                 'cudaGraphLaunch')


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m spec_tpu_torch.bench',
        description='spec_tpu_torch e2e bench (pipeline, serving, '
                    'latency, eval, train, detect)')
    parser.add_argument('--mode',
                        choices=['pipeline', 'serving', 'latency', 'eval',
                                 'train', 'detect'],
                        default='pipeline')
    parser.add_argument('--batch', type=int, default=None,
                        help='[pipeline, eval, train, detect] frames or '
                             'crops per call (default: 64 for train, 32 '
                             'for detect, else 128)')
    parser.add_argument('--frame_h', type=int, default=None,
                        help='default: 512 (pipeline) / 480 (serving, '
                             'latency); eval, train: the crop side, 224; '
                             'detect: the input side, 416')
    parser.add_argument('--frame_w', type=int, default=None,
                        help='default: 672 (pipeline) / 640 (serving, '
                             'latency)')
    parser.add_argument('--stage1', choices=['module', 'fused'],
                        default='module',
                        help='[pipeline] stage-1 trunk: the CamCalib module '
                             'or the folded-BN FusedResNet (kernel K3)')
    parser.add_argument('--dtype', choices=['bf16', 'fp32'], default='bf16',
                        help='compute dtype of the backbones and heads')
    parser.add_argument('--backbone', type=str, default='resnet50',
                        help='[eval, train] the HMR backbone')
    parser.add_argument('--eager', action='store_true',
                        help="[train] run the step's eager body, not its "
                             'CUDA graph')
    parser.add_argument('--remat', action='store_true',
                        help='[train] recompute the backbone blocks in the '
                             'backward (TRAINING.REMAT, a memory knob)')
    parser.add_argument('--iters', type=int, default=10,
                        help='calls per timed window')
    parser.add_argument('--frames', type=int, default=16,
                        help='[serving] frames per predict() call')
    parser.add_argument('--persons', type=int, default=4,
                        help='[serving] persons per frame')
    parser.add_argument('--min_size', type=int, default=600,
                        help='[serving, latency] stage-1 resize target')
    parser.add_argument('--camcalib_every', type=int, default=1,
                        help='[serving] CamCalib on every Nth frame only')
    parser.add_argument('--detector', action='store_true',
                        help='[serving] also run the in-process YOLOv3 '
                             '(random init) and time predict(frames) '
                             'without boxes, overlapped and sequential')
    parser.add_argument('--compute_only', action='store_true',
                        help='[serving] replay the stage graphs on inputs '
                             'staged on the device')
    parser.add_argument('--profile', action='store_true',
                        help='also print device busy time, idle share and '
                             'operations per call (torch.profiler)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    default_hw = FRAME_HW[args.mode]
    args.frame_h = args.frame_h or default_hw[0]
    args.frame_w = args.frame_w or default_hw[1]
    if args.batch is None:
        args.batch = BATCH.get(args.mode, 128)
    if args.iters < 1:
        parser.error('--iters must be >= 1')
    return args


def _dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == 'bf16' else torch.float32


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _device_ms(fn, device: torch.device) -> float:
    """ms of ``fn()``: CUDA events around it on a card (the device's
    time for the work queued), the host clock on the CPU."""
    if device.type != 'cuda':
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    _sync(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _host_ms(fn, device: torch.device) -> float:
    """Host-clock ms of ``fn()``, bracketed by device syncs."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def _windows(timer, fn, iters, device) -> list:
    """ms per call in each of ``WINDOWS`` windows of ``iters`` calls."""

    def window():
        for _ in range(iters):
            fn()

    return [timer(window, device) / iters for _ in range(WINDOWS)]


def device_profile(fn, n_calls: int = 3) -> dict:
    """torch.profiler over ``n_calls`` calls of ``fn`` on the card.
    Returns per call: ``busy_ms`` (the union of the device's kernel and
    copy intervals), ``device_ops`` (device kernels and copies, those
    inside graph replays included), ``host_launches`` (the host's CUDA
    calls that put work on the device: kernel launches, copies, memsets
    and graph launches), ``by_name`` (device ms per operation name),
    ``count_by_name`` (device operations per name) and ``host_by_name``
    (the host's own ms per operator or CUDA call name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        raise RuntimeError('the profiler saw no device operations')
    busy_us, end = 0.0, float('-inf')
    by_name: dict = {}
    count_by_name: dict = {}
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e3 / n_calls
        count_by_name[e.name] = count_by_name.get(e.name, 0) + 1 / n_calls
    host = [e for e in events if e.device_type == DeviceType.CPU]
    launches = sum(1 for e in host if e.name.startswith(_LAUNCH_CALLS))
    host_by_name: dict = {}
    for e in host:
        host_by_name[e.name] = (host_by_name.get(e.name, 0.0)
                                + e.self_cpu_time_total / 1e3 / n_calls)
    return {'busy_ms': busy_us / 1e3 / n_calls,
            'device_ops': len(dev) / n_calls,
            'host_launches': launches / n_calls,
            'by_name': by_name, 'count_by_name': count_by_name,
            'host_by_name': host_by_name}


def _print_profile(label, fn, call_ms) -> dict:
    p = device_profile(fn)
    print(f'[profile] {label}: device busy {p["busy_ms"]:.3f} ms per call, '
          f'idle share {1.0 - p["busy_ms"] / call_ms:.3f} (of '
          f'{call_ms:.3f} ms per call), {p["device_ops"]:.0f} device ops '
          f'and {p["host_launches"]:.0f} host launch calls per call',
          flush=True)
    return p


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0] if out else None


def _emit(args, device, metric, ms_list, value_of, unit, **extra) -> dict:
    """Print and return the result line: ``value_of(ms)`` over the
    windows' ms per call, the median as the value."""
    values = [value_of(ms) for ms in ms_list]
    payload = {
        'metric': metric,
        'value': statistics.median(values),
        'unit': unit,
        'spread': {'min': min(values), 'max': max(values),
                   'windows': len(values), 'iters': args.iters},
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu'),
        'card': _card() if device.type == 'cuda' else None,
        **extra,
    }
    print(json.dumps(payload), flush=True)
    return payload


def pipeline_bench(args, device) -> dict:
    """``build_pipeline`` on ``--batch`` raw frames, as ``bench.py``'s
    default mode draws them."""
    from spec_tpu_torch.ops.preprocess import spin_crop_corners
    from spec_tpu_torch.pipeline import build_pipeline

    B, hw = args.batch, (args.frame_h, args.frame_w)
    rng = np.random.RandomState(0)
    raw = (rng.rand(B, *hw, 3) * 255).astype('f4')
    center = (rng.rand(B, 2) * 300 + np.array([180, 100])).astype('f4')
    scale = (rng.rand(B) * 0.8 + 0.8).astype('f4')
    corners = spin_crop_corners(center, scale)
    inputs = tuple(torch.from_numpy(a).to(device)
                   for a in (raw, corners, center, scale))
    del raw
    *_, pipeline = build_pipeline(compute_dtype=_dtype(args),
                                  stage1=args.stage1, device=device)
    for _ in range(2):          # capture, then one replay
        outs = pipeline(*inputs)
    _sync(device)
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError('non-finite pipeline output')
    ms = _windows(_device_ms, lambda: pipeline(*inputs), args.iters, device)
    if args.profile and device.type == 'cuda':
        _print_profile(f'pipeline {args.stage1} {args.dtype} B={B}',
                       lambda: pipeline(*inputs), statistics.median(ms))
    bucket = f'{hw[0]}x{hw[1]}'
    return _emit(args, device,
                 f'camcalib+spec e2e inference throughput (raw frames in, '
                 f'on-device preprocessing, stage-1 bucket {bucket}, '
                 f'stage1={args.stage1}, {args.dtype}, B={B})',
                 ms, lambda m: B / m * 1e3, 'img/s/gpu',
                 ms_per_call=statistics.median(ms))


def _predictor(args, device, camcalib_every=1, detector=''):
    from spec_tpu_torch.serving import SpecPredictor

    return SpecPredictor(batch_size=32, min_size=args.min_size,
                         dtype=_dtype(args), camcalib_every=camcalib_every,
                         detector=detector, device=device)


def _serving_inputs(args):
    """``bench.py``'s serving frames and boxes, the boxes scaled from its
    480x640 frames to ``--frame_h`` x ``--frame_w``."""
    rng = np.random.RandomState(0)
    h, w = args.frame_h, args.frame_w
    sx, sy = w / 640.0, h / 480.0
    frames = [(rng.rand(h, w, 3) * 255).astype(np.uint8)
              for _ in range(args.frames)]
    boxes = [np.stack([
        np.array([(160 + 60 * k + rng.rand() * 30) * sx,
                  (240 + rng.rand() * 40) * sy, (90 + rng.rand() * 30) * sx,
                  (200 + rng.rand() * 40) * sy], np.float32)
        for k in range(args.persons)]) for _ in range(args.frames)]
    return frames, boxes


def _staged(pred, frames, boxes, every=1):
    """The predictor's stage-1 batches (every ``every``-th frame) and
    stage-2 chunks, staged on the device as ``predict`` stages them."""
    with torch.inference_mode():
        frames_dev = [pred._upload(f) for f in frames]
        cams = pred.estimate_cameras(frames)
        s1 = [b for _, b in pred._stage1_batches(frames_dev[::every])]
        s2 = [x for *_, x in pred._stage2_batches(frames_dev, boxes, cams)]
    return s1, s2


def serving_bench(args, device) -> dict:
    frames, boxes = _serving_inputs(args)
    n_persons = args.frames * args.persons
    pred = _predictor(args, device, args.camcalib_every,
                      'yolo' if args.detector else '')
    for _ in range(2):          # captures for every padded shape
        pred.predict(frames, boxes)
        pred.reset_camera_stream()
    every = f', camcalib_every={args.camcalib_every}' \
        if args.camcalib_every > 1 else ''
    where = (f'{args.persons} persons/frame, {args.frames} frames of '
             f'{args.frame_h}x{args.frame_w}, stage-1 min_size='
             f'{args.min_size}, {args.dtype}{every}')

    if args.compute_only:
        s1, s2 = _staged(pred, frames, boxes, args.camcalib_every)

        def one_pass():
            for b in s1:
                pred._stage1(b)
            for x in s2:
                pred._stage2(*x)

        one_pass()
        ms = _windows(_device_ms, one_pass, args.iters, device)
        if args.profile and device.type == 'cuda':
            _print_profile(f'serving compute_only ({where})', one_pass,
                           statistics.median(ms))
        return _emit(args, device,
                     f'serving engine throughput (stage graphs replayed on '
                     f'inputs staged on the device), {where}', ms,
                     lambda m: n_persons / m * 1e3, 'persons/s/gpu',
                     ms_per_pass=statistics.median(ms),
                     stage1_batches=len(s1), stage2_chunks=len(s2))

    def call():
        results = pred.predict(frames, boxes)
        if sum(len(r) for r in results) != n_persons:
            raise RuntimeError('predict lost persons')

    ms = _windows(_host_ms, call, args.iters, device)
    if args.profile and device.type == 'cuda':
        _print_profile(f'serving predict ({where})', call,
                       statistics.median(ms))
    extra = _detector_ms(pred, frames, args, device) if args.detector \
        else {}
    return _emit(args, device, f'serving predict() e2e, {where}', ms,
                 lambda m: n_persons / m * 1e3, 'persons/s/gpu',
                 ms_per_call=statistics.median(ms),
                 ms_per_call_spread=[min(ms), max(ms)], **extra)


def _detector_ms(pred, frames, args, device) -> dict:
    """``serving --detector``: ms per frame of ``predict(frames)`` with
    the predictor's detector (detection and stage 1 queued before
    either is fetched) and of the sequential order (``detect`` fetched
    first, then ``predict(frames, boxes)``): the same work both ways,
    medians of the windows by the host clock."""
    def overlapped():
        pred.predict(frames)

    def sequential():
        pred.predict(frames, boxes=pred.detector.detect(frames))

    for fn in (overlapped, sequential):
        for _ in range(2):      # captures for every padded shape
            fn()
    n = len(frames)
    out = {}
    for name, fn in (('overlap', overlapped), ('sequential', sequential)):
        ms = _windows(_host_ms, fn, args.iters, device)
        out[f'detect_stage1_{name}_ms_per_frame'] = statistics.median(ms) / n
        out[f'detect_stage1_{name}_spread'] = [min(ms) / n, max(ms) / n]
    return out


def latency_bench(args, device) -> dict:
    rng = np.random.RandomState(0)
    h, w = args.frame_h, args.frame_w
    frame = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    box = np.array([[320.0 * w / 640, 240.0 * h / 480, 100.0 * w / 640,
                     220.0 * h / 480]], np.float32)
    pred = _predictor(args, device)
    for _ in range(3):          # both batch-1 stage captures
        out = pred.predict([frame], [box])
    if len(out[0]) != 1:
        raise RuntimeError('predict lost the person')
    e2e = _windows(_host_ms, lambda: pred.predict([frame], [box]),
                   args.iters, device)
    (s1,), (s2,) = _staged(pred, [frame], [box])
    stage1 = _windows(_device_ms, lambda: pred._stage1(s1), args.iters,
                      device)
    stage2 = _windows(_device_ms, lambda: pred._stage2(*s2), args.iters,
                      device)
    if args.profile and device.type == 'cuda':
        _print_profile(f'latency predict ({h}x{w}, 1 person)',
                       lambda: pred.predict([frame], [box]),
                       statistics.median(e2e))
    s1_ms, s2_ms = statistics.median(stage1), statistics.median(stage2)
    return _emit(args, device,
                 f'single-frame latency ({h}x{w}, 1 person, stage-1 '
                 f'min_size={args.min_size}, {args.dtype})', e2e,
                 lambda m: m, 'ms/frame e2e',
                 stage1_ms=s1_ms, stage2_ms=s2_ms, compute_ms=s1_ms + s2_ms,
                 stage1_spread=[min(stage1), max(stage1)],
                 stage2_spread=[min(stage2), max(stage2)])


def eval_inputs(B: int, res: int, seed: int = 0) -> dict:
    """``bench.py``'s ``eval_bench`` batch as numpy arrays in the eval
    step's layout (``eval_loop.BATCH_KEYS``): B crops of res² (its
    values are already normalized there; here they go through the
    step's normalization, an affine map of the same cost), GT pose and
    shape, a random gender per sample, boxes in a 1920x1080 frame and
    its camera."""
    rng = np.random.RandomState(seed)
    K = np.tile(np.array([[1000., 0., 960.], [0., 1000., 540.],
                          [0., 0., 1.]], 'f4'), (B, 1, 1))
    return {
        'img': rng.randn(B, res, res, 3).astype('f4'),
        'pose': (rng.randn(B, 72) * 0.15).astype('f4'),
        'betas': (rng.randn(B, 10) * 0.3).astype('f4'),
        'gender': (rng.rand(B) > 0.5).astype(np.int32),
        'scale': (rng.rand(B) * 0.8 + 0.8).astype('f4'),
        'center': (rng.rand(B, 2) * 300
                   + np.array([600, 300])).astype('f4'),
        'orig_shape': np.tile(np.array([[1080., 1920.]], 'f4'), (B, 1)),
        'cam_rotmat': np.tile(np.eye(3, dtype='f4'), (B, 1, 1)),
        'cam_intrinsics': K,
    }


def eval_model(backbone: str, dtype: torch.dtype, device, img_res=224):
    """The eval bench's HMR: camera-aware with camera features, random
    weights from seed 0, on ``device`` in eval mode."""
    from spec_tpu_torch.models.hmr import HMR

    model = HMR(backbone=backbone, use_cam=True, use_cam_feats=True,
                img_res=img_res, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def eval_assets() -> dict:
    """Three synthetic asset sets (V = 6890), as ``bench.py`` makes
    them: neutral, male and female from seeds 0, 1 and 2."""
    from spec_tpu_torch.core import smpl as S

    return {g: S.create_test_assets(seed=i)
            for i, g in enumerate(('neutral', 'male', 'female'))}


def eval_bench(args, device) -> dict:
    """The eval step, gendered, on one batch of ``eval_inputs``."""
    from spec_tpu_torch.eval.eval_loop import make_eval_step

    B, res = args.batch, args.frame_h
    assets = eval_assets()
    model = eval_model(args.backbone, _dtype(args), device, img_res=res)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in eval_inputs(B, res).items()}
    step = make_eval_step(model, assets,
                          assets['neutral'].j_regressor_h36m.numpy(),
                          use_gender=True)
    for _ in range(2):          # capture, then one replay
        out, j14, j24, v2v = step(batch)
    _sync(device)
    if not all(bool(torch.isfinite(t).all()) for t in
               (v2v, out['smpl_vertices'], *j14.values(), *j24.values())):
        raise RuntimeError('non-finite eval step output')
    ms = _windows(_host_ms, lambda: step(batch), args.iters, device)
    if args.profile and device.type == 'cuda':
        _print_profile(f'eval step {args.backbone} {args.dtype} B={B}',
                       lambda: step(batch), statistics.median(ms))
    return _emit(args, device,
                 f'SPEC eval step (fwd + gendered GT SMPL through K1 + J14 '
                 f'Procrustes/J24/V2V, {args.backbone}, {args.dtype}), '
                 f'B={B} {res}^2', ms, lambda m: B / m * 1e3, 'img/s/gpu',
                 ms_per_step=statistics.median(ms))


def train_inputs(B: int, res: int, seed: int = 0) -> dict:
    """``bench.py``'s train batch (``__graft_entry__._example_inputs``
    and ``_example_batch``, drawn in their order) as numpy arrays in the
    train step's layout (``train/steps.SPEC_BATCH_KEYS``)."""
    from spec_tpu_torch.core import geometry as G

    rng = np.random.RandomState(seed)
    img = rng.randn(B, res, res, 3).astype('f4')
    rotmat = G.euler_to_rotmat(torch.from_numpy(
        rng.randn(B, 3).astype('f4') * 0.1)).numpy()
    K = G.build_cam_intrinsics(torch.full((B,), 1500.0),
                               torch.full((B,), 1920.0),
                               torch.full((B,), 1080.0)).numpy()
    center = rng.rand(B, 2).astype('f4') * 800 + 300
    scale = rng.rand(B).astype('f4') + 1.0
    return {
        'img': img,
        'pose': rng.randn(B, 72).astype('f4') * 0.2,
        'betas': rng.randn(B, 10).astype('f4') * 0.3,
        'pose_conf': np.ones((B, 24), 'f4'),
        'pose_3d': rng.randn(B, 24, 4).astype('f4'),
        'keypoints_orig': np.concatenate(
            [rng.rand(B, 49, 2) * 1000, np.ones((B, 49, 1))],
            -1).astype('f4'),
        'has_smpl': np.ones((B,), 'f4'),
        'has_pose_3d': np.ones((B,), 'f4'),
        'orig_shape': np.tile(np.array([[1080.0, 1920.0]], 'f4'), (B, 1)),
        'scale': scale,
        'center': center,
        'cam_rotmat': rotmat,
        'cam_intrinsics': K,
    }


def train_setup(B: int, backbone: str, dtype: torch.dtype, device,
                res: int = 224, remat: bool = False):
    """``bench.py``'s ``_train_setup``: synthetic SMPL (V = 6890; K1's
    packed operands on a card), the HMR with camera features (``remat``:
    its blocks checkpointed), random weights from seed 0 with zeroed head
    decoders, Adam 1e-4 (the init buffers trained, as ``adam`` does
    there), the step and its batch on ``device``. Returns (state, step,
    batch)."""
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.train import (
        adam,
        create_train_state,
        make_spec_train_step,
    )

    assets = S.create_test_assets()
    model = HMR(backbone=backbone, use_cam=True, use_cam_feats=True,
                dtype=dtype, remat=remat)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for dec in (model.head.decpose, model.head.decshape,
                    model.head.deccam):
            dec.weight.zero_()
            dec.bias.zero_()
    model = model.to(device).train()
    state = create_train_state(model, adam(1e-4))
    step = make_spec_train_step(model, assets)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in train_inputs(B, res).items()}
    return state, step, batch


def train_bench(args, device) -> dict:
    """The SPEC train step on one fixed batch, in place on one state."""
    B, res = args.batch, args.frame_h
    state, step, batch = train_setup(B, args.backbone, _dtype(args), device,
                                     res, remat=args.remat)
    gen = torch.Generator(device=device).manual_seed(1)
    run = step.eager if args.eager else step

    def call():
        return run(state, batch, gen)[1]['loss/total_loss']

    for _ in range(2):          # the eager first step and capture, a replay
        total = call()
    _sync(device)
    if not math.isfinite(float(total)):
        raise RuntimeError('non-finite train loss')
    ms = _windows(_host_ms, call, args.iters, device)
    mode = 'graph' if device.type == 'cuda' and not args.eager else 'eager'
    if args.profile and device.type == 'cuda':
        p = _print_profile(f'train step {args.backbone} {args.dtype} B={B} '
                           f'({mode})', call, statistics.median(ms))
        k1 = {n: v for n, v in p['by_name'].items() if 'lbs_kernel' in n}
        k1_count = sum(c for n, c in p['count_by_name'].items()
                       if 'lbs_kernel' in n)
        print(f'[profile] train step K1: {k1_count:.0f} launches per step, '
              f'{sum(k1.values()):.4f} ms of device time per step',
              flush=True)
    return _emit(args, device,
                 f'SPEC train step (fwd + GT/pred SMPL through K1 + loss + '
                 f'bwd + Adam in place, {mode}, {args.backbone}'
                 + (', remat' if args.remat else '')
                 + f', {args.dtype}), B={B} {res}^2', ms,
                 lambda m: B / m * 1e3, 'img/s/gpu',
                 ms_per_step=statistics.median(ms))


def detect_bench(args, device) -> dict:
    """The YOLOv3 forward and top-K person filter (``YoloDetector``'s
    stage graph) on ``--batch`` random inputs of ``--frame_h``², as
    ``bench.py``'s ``detect_bench`` draws them."""
    from spec_tpu_torch.models.detector import YoloDetector

    B, S = args.batch, args.frame_h
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(B, S, S, 3).astype('f4')).to(device)
    det = YoloDetector(img_size=S, batch_size=B, seed=0,
                       dtype=_dtype(args), device=device)
    for _ in range(2):          # capture, then one replay
        cand = det._fwd(x)
    _sync(device)
    if cand.shape != (B, min(256, 3 * 21 * (S // 32) ** 2), 5) or not bool(
            torch.isfinite(cand).all()):
        raise RuntimeError(f'bad detector output {tuple(cand.shape)}')
    ms = _windows(_device_ms, lambda: det._fwd(x), args.iters, device)
    if args.profile and device.type == 'cuda':
        _print_profile(f'detect {S}^2 {args.dtype} B={B}',
                       lambda: det._fwd(x), statistics.median(ms))
    return _emit(args, device,
                 f'yolov3 person detection ({S}^2 {args.dtype}, device '
                 f'top-K), B={B}', ms, lambda m: B / m * 1e3, 'img/s/gpu',
                 ms_per_batch=statistics.median(ms))


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        print('spec_tpu_torch.bench: no CUDA card (torch.cuda.is_available() '
              'is False); the bench measures an NVIDIA GPU and never runs on '
              'the CPU unasked: pass --device cpu for a CPU run',
              file=sys.stderr)
        return 2
    if device.type not in ('cuda', 'cpu'):
        print(f'spec_tpu_torch.bench: unsupported device {device}',
              file=sys.stderr)
        return 2
    bench = {'pipeline': pipeline_bench, 'serving': serving_bench,
             'latency': latency_bench, 'eval': eval_bench,
             'train': train_bench, 'detect': detect_bench}[args.mode]
    # Training needs autograd; every other mode runs in inference mode.
    with (contextlib.nullcontext() if args.mode == 'train'
          else torch.inference_mode()):
        bench(args, device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
