"""The port's benchmark: ``python -m spec_tpu_torch.bench``.

The counterpart of ``bench.py``'s ``pipeline``, ``serving``,
``latency``, ``eval``, ``train``, ``detect`` and ``input`` modes
(argument names and defaults from there; ``--stage1 flax`` is ``module``
here, and ``--dtype`` picks the compute dtype):

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

* ``input``: the host loader (``data/cam_dataset.CamDataset`` through
  ``data/loader.DataLoader``, ``--workers`` threads) over a synthetic
  3DPW-shaped set written once under ``--bench_data`` (``--frame_h`` x
  ``--frame_w`` JPEG frames, 1080x1920 by default, four person samples
  per frame): JPEG decode (the native region-of-interest engine unless
  ``--no_native_decode``; ``--fast_decode``, ``--decode_cache``,
  ``--group_by_frame``, ``--region_cache``), SPIN crop and, for
  ``--input_step train``, the training augmentations. The value is the
  loader's img/s, one window per whole epoch (at least 12 batches in
  all); the e2e tail then feeds the same batches to the port's train
  step (uint8 crops uploaded, normalized on the device) or, with
  ``--input_step eval``, to the eval step, and reports the step's
  ceiling on a batch already on the device and loader -> upload -> step
  img/s. ``camcalib_input`` (``--input_step camcalib``): the CamCalib
  pano loader's items per second on one thread (``--camcalib_jitter``,
  ``--camcalib_split``, ``--decode_cache``, ``--fast_decode``), with
  ``--camcalib_e2e`` the loader -> upload -> CamCalib train step on one
  shape bucket. Writing the data needs cv2 (and joblib for the pano
  splits); the machine with the card has neither, so these modes run
  where they are, with ``--device cpu`` or a card.

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
import os
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
            'detect': (416, 416), 'input': (1080, 1920)}
MODES = (*FRAME_HW, 'camcalib_input')
# bench.py's synthetic sets: frames of the input set (at least three
# batches of four samples per frame), and the images of the camcalib set
# with the reference datagen's crop sizes (W, H) and the loader's
# (min_size, max_size).
INPUT_FRAMES = 96
CAMCALIB_IMAGES = 96
CAMCALIB_SIZES = ((640, 640), (750, 600), (800, 600), (900, 600),
                  (992, 558), (558, 992))
CAMCALIB_MIN_MAX = (600, 1000)
BENCH_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '.bench_data')
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
                    'latency, eval, train, detect, input, camcalib_input)')
    parser.add_argument('--mode', choices=MODES, default='pipeline',
                        help='camcalib_input is input with --input_step '
                             'camcalib')
    parser.add_argument('--batch', type=int, default=None,
                        help='[pipeline, eval, train, detect, input] frames '
                             'or crops per call (default: 64 for train, '
                             '32 for detect, else 128)')
    parser.add_argument('--frame_h', type=int, default=None,
                        help='default: 512 (pipeline) / 480 (serving, '
                             'latency) / 1080 (input); eval, train: the '
                             'crop side, 224; detect: the input side, 416')
    parser.add_argument('--frame_w', type=int, default=None,
                        help='default: 672 (pipeline) / 640 (serving, '
                             'latency) / 1920 (input)')
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
    parser.add_argument('--workers', type=int, default=8,
                        help='[input] loader worker threads (the '
                             "reference's NUM_WORKERS)")
    parser.add_argument('--fast_decode', action='store_true',
                        help='[input] reduced-scale JPEG decode in the '
                             'loader (CamDataset fast_decode)')
    parser.add_argument('--decode_cache', type=int, default=0,
                        help='[input] decoded-frame LRU capacity (frames; '
                             '0 = off)')
    parser.add_argument('--group_by_frame', action='store_true',
                        help='[input] frame-grouped shuffle, so samples of '
                             'one frame share a batch')
    parser.add_argument('--no_native_decode', action='store_true',
                        help='[input] the cv2 decode and crop (the parity '
                             'oracle) instead of the native engine')
    parser.add_argument('--region_cache', action='store_true',
                        help='[input] per-sample crop-region cache: the '
                             'warm-up epoch fills it, measured epochs '
                             'read it')
    parser.add_argument('--region_cache_format', type=str, default='jpeg',
                        choices=['jpeg', 'raw'],
                        help='[input] region cache file format')
    parser.add_argument('--input_step', choices=['train', 'eval', 'camcalib'],
                        default='train',
                        help='[input] the device step the loader feeds '
                             '(camcalib: the pano loader, as --mode '
                             'camcalib_input)')
    parser.add_argument('--camcalib_jitter', choices=['fused', 'pil',
                                                      'device'],
                        default='fused',
                        help='[camcalib_input] train jitter: one fused '
                             'affine (default), four PIL passes, or on the '
                             'device')
    parser.add_argument('--camcalib_split', choices=['train', 'val'],
                        default='train',
                        help='[camcalib_input] split (val: no jitter)')
    parser.add_argument('--camcalib_secs', type=float, default=8.0,
                        help='[camcalib_input] shortest timed window (s)')
    parser.add_argument('--camcalib_e2e', action='store_true',
                        help='[camcalib_input] also loader -> upload -> '
                             'CamCalib train step on one shape bucket')
    parser.add_argument('--bench_data', default=BENCH_DATA,
                        help='[input] where the synthetic data sets are '
                             'written once and reused')
    args = parser.parse_args(argv)
    if args.mode == 'camcalib_input':
        args.mode, args.input_step = 'input', 'camcalib'
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

    # Built outside inference mode: a stage folds its ResNet trunk only
    # from tensors that keep version counters.
    with torch.inference_mode(False):
        return SpecPredictor(batch_size=32, min_size=args.min_size,
                             dtype=_dtype(args),
                             camcalib_every=camcalib_every,
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


def make_input_bench_data(root, n_frames=96, samples_per_frame=4,
                          hw=(1080, 1920)):
    """``bench.py``'s synthetic 3DPW-shaped set on disk: ``n_frames``
    JPEG frames of ``hw`` (smooth gradients and noise, which compress
    like photos) and the npz annotation contract with
    ``samples_per_frame`` person samples per frame. Written once per
    (root, size) and reused while it holds enough samples. Returns
    (npz path, image directory)."""
    import cv2

    npz = os.path.join(root, 'annots.npz')
    if os.path.exists(npz) and len(np.load(npz)['imgname']) >= (
            n_frames * samples_per_frame):
        return npz, root
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    names = []
    for i in range(n_frames):
        base = 128 + 80 * np.sin(xx / (47.0 + i)) * np.cos(yy / (39.0 + i))
        img = np.clip(base[..., None] + rng.randn(H, W, 3) * 10, 0, 255)
        nm = f'im{i:04d}.jpg'
        cv2.imwrite(os.path.join(root, nm), img.astype('u1'))
        names.append(nm)
    n = n_frames * samples_per_frame
    sy, sx = H / 1080.0, W / 1920.0      # bench.py's boxes, scaled
    np.savez(
        npz,
        imgname=np.repeat(np.array(names), samples_per_frame),
        scale=((rng.rand(n) * 1.2 + 1.0) * min(sy, sx)).astype('f4'),
        center=np.stack([(rng.rand(n) * 1200 + 360) * sx,
                         (rng.rand(n) * 500 + 290) * sy], 1).astype('f4'),
        pose_0yaw_inverseyz=(rng.randn(n, 72) * 0.2).astype('f4'),
        pose_cam=(rng.randn(n, 72) * 0.2).astype('f4'),
        shape=(rng.randn(n, 10) * 0.5).astype('f4'),
        S=rng.randn(n, 24, 4).astype('f4'),
        part=np.concatenate([rng.rand(n, 24, 2) * 800 + 200,
                             np.ones((n, 24, 1))], -1).astype('f4'),
        cam_int=np.tile(np.array(
            [[1000, 0, W / 2], [0, 1000, H / 2], [0, 0, 1]], 'f4'),
            (n, 1, 1)),
        camcalib_pitch=(rng.randn(n) * 0.1).astype('f4'),
        camcalib_roll=(rng.randn(n) * 0.05).astype('f4'),
        camcalib_vfov=(rng.rand(n) * 0.5 + 0.6).astype('f4'),
        camcalib_f_pix=(rng.rand(n) * 200 + 900).astype('f4'),
    )
    return npz, root


def make_camcalib_bench_data(root):
    """``bench.py``'s synthetic Pano360-crop set in the pano_scalenet
    layout (images/*.jpg, a JSON annotation beside each, the split
    pickles): ``CAMCALIB_IMAGES`` images at ``CAMCALIB_SIZES``. Written
    once per root. Returns the root."""
    import cv2
    import joblib

    img_dir = os.path.join(root, 'images')
    split_pkl = os.path.join(root, 'train_images.pkl')
    if os.path.exists(split_pkl):
        return root
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    n, sizes = CAMCALIB_IMAGES, CAMCALIB_SIZES
    names = []
    for i in range(n):
        W, H = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:H, 0:W]
        base = (128 + 80 * np.sin(xx / (31.0 + i % 7))
                * np.cos(yy / (27.0 + i % 5)))
        img = np.clip(base[..., None] + rng.randn(H, W, 3) * 10, 0, 255)
        nm = f'crop{i:04d}.jpg'
        cv2.imwrite(os.path.join(img_dir, nm), img.astype('u1'))
        with open(os.path.join(img_dir, nm[:-4] + '.json'), 'w') as f:
            json.dump({'vfov': 1.05 + 0.3 * (i % 5) / 5.0,
                       'pitch': 0.05 - 0.02 * (i % 3),
                       'roll': -0.02 + 0.01 * (i % 4)}, f)
        names.append(nm)
    split = max(1, int(n * 0.85))
    joblib.dump(names[:split], split_pkl)
    joblib.dump(names[split:], os.path.join(root, 'val_images.pkl'))
    return root


def _emit_rates(args, device, metric, rates, unit, **extra) -> dict:
    """Print and return the result line for rates measured per window
    (the input modes: one window per whole epoch)."""
    payload = {
        'metric': metric,
        'value': statistics.median(rates),
        'unit': unit,
        'spread': {'min': min(rates), 'max': max(rates),
                   'windows': len(rates)},
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu'),
        'card': _card() if device.type == 'cuda' else None,
        **extra,
    }
    print(json.dumps(payload), flush=True)
    return payload


def _step_rates(step_fn, first, batches, B, device, min_steps):
    """(ceiling img/s: ``step_fn`` on ``first()``, a batch already on the
    device, ``min_steps`` times; e2e img/s: ``batches()`` (whole epochs
    of (upload, valid rows)) uploaded and stepped until ``min_steps``
    steps)."""
    dev = first()
    step_fn(dev)                      # the eager first call and capture
    step_fn(dev)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(min_steps):
        step_fn(dev)
    _sync(device)
    ceiling = B * min_steps / (time.perf_counter() - t0)
    n = steps = 0
    t0 = time.perf_counter()
    while steps < min_steps:
        for upload, valid in batches():
            step_fn(upload())
            n += valid
            steps += 1
    _sync(device)
    return ceiling, n / (time.perf_counter() - t0)


def input_bench(args, device) -> dict:
    """The host loader at ``bench.py``'s ``input_bench`` setup, then the
    train or eval step fed from it (see the module docstring)."""
    from spec_tpu_torch.data.cam_dataset import CamDataset
    from spec_tpu_torch.data.loader import DataLoader

    if args.input_step == 'camcalib':
        return camcalib_input_bench(args, device)
    B, hw = args.batch, (args.frame_h, args.frame_w)
    root = os.path.join(args.bench_data, f'input_{hw[0]}x{hw[1]}')
    # (an existing set is reused while it holds enough samples)
    npz, img_dir = make_input_bench_data(
        root, n_frames=max(INPUT_FRAMES, (3 * B + 3) // 4), hw=hw)
    rc_dir = (os.path.join(root, f'region_cache_{args.region_cache_format}')
              if args.region_cache else '')
    is_train = args.input_step == 'train'
    ds = CamDataset(npz, img_dir, '3dpw-test-cam', is_train=is_train,
                    fast_decode=args.fast_decode,
                    decode_cache=args.decode_cache,
                    native_decode=not args.no_native_decode,
                    region_cache_dir=rc_dir,
                    region_cache_format=args.region_cache_format)
    loader = DataLoader(ds, batch_size=B, shuffle=is_train,
                        num_workers=args.workers, drop_last=True,
                        group_keys=ds.imgname if args.group_by_frame
                        else None)
    # Warm-up epoch, drained: an abandoned iterator would keep its
    # threads decoding into the timed window.
    warm = iter(loader)
    first = next(warm)
    for _ in warm:
        pass
    rates, batches = [], 0
    while batches < 12:               # whole epochs
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            n += len(batch['scale'])
            batches += 1
        rates.append(n / (time.perf_counter() - t0))
    desc = (f'{hw[0]}x{hw[1]} JPEG decode + SPIN crop'
            + (' + aug' if is_train else '')
            + (', cv2' if args.no_native_decode else ', native ROI')
            + (', fast_decode' if args.fast_decode else '')
            + (f', decode_cache {args.decode_cache}' if args.decode_cache
               else '')
            + (f', region_cache {args.region_cache_format}'
               if args.region_cache else ''))
    res = first['img'].shape[1]
    # the tails' ceiling batch is the drained warm-up epoch's first
    if args.input_step == 'eval':
        ceiling, e2e = _input_eval_tail(args, device, loader, first, B)
        upload = B * res * res * 3 * 4
    else:
        ceiling, e2e = _input_train_tail(args, device, loader, first, B,
                                         res)
        upload = B * res * res * 3
    return _emit_rates(
        args, device, f'host input pipeline ({desc}, {args.workers} '
        f'workers) -> {args.input_step} step, B={B}', rates, 'img/s',
        **{f'{args.input_step}_e2e_img_s': e2e,
           'device_step_ceiling_img_s': ceiling,
           'upload_mb_per_batch': upload / 1e6,
           'native_decode': bool(ds._native_ok()),
           'region_cache_hits': (ds._region_cache.hits
                                 if ds._region_cache is not None else None)})


def _input_train_tail(args, device, loader, first, B, res):
    """The SPEC train step fed by the loader: crops uploaded as uint8
    and normalized on the device, the other columns as float32."""
    from spec_tpu_torch.core import constants as C
    from spec_tpu_torch.train.steps import SPEC_BATCH_KEYS
    from spec_tpu_torch.utils.graphs import device_constant

    state, step, _ = train_setup(B, args.backbone, _dtype(args), device, res)
    gen = torch.Generator(device=device).manual_seed(1)
    mean = device_constant(C.IMG_NORM_MEAN, device)
    std = device_constant(C.IMG_NORM_STD, device)

    def upload(batch):
        def put():
            u8 = np.clip(batch['img'] * 255.0, 0, 255).astype(np.uint8)
            dev = {k: torch.from_numpy(np.ascontiguousarray(
                batch['cam_int' if k == 'cam_intrinsics' else k],
                np.float32)).to(device, non_blocking=True)
                for k in SPEC_BATCH_KEYS if k != 'img'}
            img = torch.from_numpy(u8).to(device, non_blocking=True)
            dev['img'] = (img.float() / 255.0 - mean) / std
            return dev
        return put, B

    def step_fn(dev):
        return step(state, dev, gen)

    return _step_rates(step_fn, upload(first)[0],
                       lambda: (upload(b) for b in loader), B, device,
                       max(args.iters, 8))


def _input_eval_tail(args, device, loader, first, B):
    """The eval step fed by the loader: float32 [0, 1] crops (the step
    normalizes them) and CamCalib's camera columns, as
    ``evaluate_dataset`` uploads them."""
    from spec_tpu_torch.eval.eval_loop import BATCH_KEYS, make_eval_step

    assets = eval_assets()
    model = eval_model(args.backbone, _dtype(args), device)
    step = make_eval_step(model, assets,
                          assets['neutral'].j_regressor_h36m.numpy())
    src = dict(zip(BATCH_KEYS, BATCH_KEYS), cam_rotmat='pred_cam_rotmat',
               cam_intrinsics='pred_cam_int')

    def upload(batch):
        def put():
            return {k: torch.from_numpy(np.ascontiguousarray(
                batch[src[k]])).to(device, non_blocking=True)
                for k in BATCH_KEYS}
        return put, B

    def step_fn(dev):
        out = step(dev)
        return out[0]['pred_cam_t']

    with torch.inference_mode():
        return _step_rates(step_fn, upload(first)[0],
                           lambda: (upload(b) for b in loader), B, device,
                           max(args.iters, 8))


def camcalib_input_bench(args, device) -> dict:
    """The CamCalib pano loader's items on one thread (img/s per core),
    and with ``--camcalib_e2e`` the loader -> upload -> CamCalib train
    step on one bucket."""
    from spec_tpu_torch.data.pano_dataset import (
        CameraRegressorDataset,
        color_jitter,
        normalize_u8,
    )

    if args.camcalib_jitter == 'pil' and (args.decode_cache
                                          or args.camcalib_split == 'val'
                                          or args.camcalib_e2e):
        raise SystemExit('--camcalib_jitter pil is the four-pass train item '
                         'baseline: it bypasses the decode cache and always '
                         'jitters; drop --decode_cache/--camcalib_split '
                         'val/--camcalib_e2e')
    root = make_camcalib_bench_data(
        os.path.join(args.bench_data, 'camcalib_crops'))
    is_train = args.camcalib_split == 'train'
    min_size, max_size = CAMCALIB_MIN_MAX
    ds = CameraRegressorDataset(
        root, 'pano_scalenet', is_train=is_train, min_size=min_size,
        max_size=max_size, loss_type='softargmax_biased_l2',
        fast_decode=args.fast_decode, decode_cache=args.decode_cache,
        device_jitter=args.camcalib_jitter == 'device')
    if args.camcalib_jitter == 'pil':
        from PIL import Image

        rng = np.random.RandomState(0)

        def item(i):
            name = os.path.join(root, 'images', ds.image_filenames[i])
            arr, _ = ds._decode_resized(name)
            return normalize_u8(np.asarray(
                color_jitter(Image.fromarray(arr), rng), np.uint8))
    else:
        item = ds.__getitem__
    n_ds = len(ds)
    for i in range(n_ds):             # warm-up epoch (fills the caches)
        item(i)
    rates = []
    t_all = time.perf_counter()
    while len(rates) < 3 or time.perf_counter() - t_all < args.camcalib_secs:
        t0 = time.perf_counter()
        for i in range(n_ds):
            item(i)
        rates.append(n_ds / (time.perf_counter() - t0))
    desc = ('PIL 4-pass jitter' if args.camcalib_jitter == 'pil'
            else 'device jitter (u8 + affine)'
            if args.camcalib_jitter == 'device'
            else 'fused-affine jitter' if is_train else 'no jitter (val)')
    if args.decode_cache:
        desc += f' + decode_cache {args.decode_cache}'
    extra = {'n_images': n_ds}
    if args.camcalib_e2e:
        hw, ceiling, e2e = _camcalib_e2e_tail(args, device, ds)
        extra.update(bucket=list(hw), device_step_ceiling_img_s=ceiling,
                     train_e2e_img_s=e2e)
    return _emit_rates(
        args, device, f'camcalib {args.camcalib_split} loader item ({desc}), '
        f'min {min_size}, one thread', rates, 'img/s/core', **extra)


def _camcalib_e2e_tail(args, device, ds, B=8):
    """The CamCalib train step (``--backbone``, random init, Adam 1e-4,
    fp32) fed by the bucketed loader, on the bucket with the most
    samples. Returns (bucket, ceiling img/s, e2e img/s)."""
    from spec_tpu_torch.cli.camcalib_train import _bucketed_batches
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.train import (
        adam,
        create_train_state,
        make_camcalib_train_step,
    )

    model = CameraRegressorNetwork(backbone=args.backbone)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device).train()
    state = create_train_state(model, adam(1e-4))
    step = make_camcalib_train_step(model, loss_type='softargmax_biased_l2')
    buckets = ds.shape_buckets()
    hw = max(buckets, key=lambda k: len(buckets[k]))
    keys = ('img', 'vfov', 'pitch', 'roll', 'jitter_A', 'jitter_b',
            'true_shape')

    def batches():
        for b in _bucketed_batches(ds, B, shuffle=True, seed=0,
                                   num_workers=args.workers):
            if tuple(b['img'].shape[1:3]) != tuple(hw):
                continue

            def put(b=b):
                return {k: torch.from_numpy(np.ascontiguousarray(
                    b[k] if k != 'true_shape'
                    else b[k].astype(np.int32))).to(device,
                                                    non_blocking=True)
                    for k in keys if k in b}
            yield put, int(b.get('valid_count', B))

    def step_fn(dev):
        return step(state, dev)

    # the first batch of a whole (drained) epoch
    first = [put for put, _ in batches()][0]
    ceiling, e2e = _step_rates(step_fn, first, batches, B, device,
                               max(args.iters, 6))
    return hw, ceiling, e2e


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
             'train': train_bench, 'detect': detect_bench,
             'input': input_bench}[args.mode]
    # Training needs autograd (so do the input mode's train tails; its
    # eval tail enters inference mode itself); every other mode runs in
    # inference mode.
    with (contextlib.nullcontext() if args.mode in ('train', 'input')
          else torch.inference_mode()):
        bench(args, device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
