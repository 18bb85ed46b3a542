#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spec_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its own results; any failure raises and exits nonzero:

1. device: CUDA must be available (there is no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the three kernels of ``spec_tpu_torch/csrc/`` (K1
   ``lbs``, K3 ``bottleneck``, K2 ``projection``), one ``nvcc`` each,
   and the host rasterizer ``raster.cpp`` with ``g++``, all started
   together;
3. K3 against its plain version at every ResNet-50 stage's identity-block
   shape on 16 frames of 512x672 (one block each) and at an odd H and W
   (a chain of 3), in fp32 and bf16, timed beside the port's unfused
   cuDNN ``Bottleneck`` module at the same shape, with its TFLOP/s, the
   tile it picks and its share of the bound (the larger of operations at
   the peak rate of the tensor cores for the dtype, bf16 or three TF32
   products per fp32 one, and bytes at the HBM rate);
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
   batches phases 4 and 5 gave it, the eval step's 128 and
   ``compute_error``'s chunk of 256;
7. K2 projects the fp32 fused pipeline's meshes (16 x 6890 vertices) with
   its cameras, against its plain version and
   ``geometry.perspective_projection`` (0.01 px budget).
   Phases 6 and 7 time each kernel apart from its wrapper: the kernel's
   own device time (torch.profiler, by kernel name, L2 flushed before
   each call), the wrapper's host wall per call (with a sync) and the
   device operations per call;
8. small models on the card and on the CPU must agree: the predictor
   (ResNet-18) and the pipelines (ResNet-50, 64x96 frames; both trunks
   in fp32 and the fused trunk in bf16, where the CPU runs K3's plain
   version);
9. graphs: on the card every stage replays a CUDA graph
   (``spec_tpu_torch/utils/graphs.py``). The replays are held to the
   eager stage bodies (bit for bit where they agree so, else within the
   card-vs-CPU limits of phase 8): ``predict`` in fp32 and bf16 at phase
   4's input, the camcalib_every=3 stream, calls of 40 and 64 persons
   (stage-2 chunks 32 + 8 and 32 + 32, the latter one graph replayed
   twice in a call) and both pipelines in both dtypes; per call, the
   device operations, the host's launch calls, the wall ms and the
   profiler's count of ``lbs_kernel`` and ``bottleneck_tc_kernel``
   launches; then ``python -m spec_tpu_torch.bench`` once per mode
   (pipeline at B = 128, serving with and without ``--compute_only``,
   latency) at a small ``--iters``, each printing its JSON line;
10. K1's gradient: autograd through ``fused_lbs_vertices`` (the kernel
    forward plus the closed-form backward) against autograd through its
    plain version at B = 1, 8 and 32, all four cotangents within 1e-4 of
    each one's largest entry;
11. the device functions of the folder CLIs at full ResNet-50 width,
    card against CPU: ``camcalib_demo``'s stage 1 on a padded batch of
    16 resized frames, ``spec_demo``'s stage 2 on crops cut on the device
    from two 480x640 frames;
12. serve: ``spec_tpu_torch.cli.serve``'s server in-process over the
    predictor its default flags build, eight concurrent clients posting
    480x640 frames: a warm-up under load (the first graph captures with
    requests queued), one request of each padded batch size, two
    requests coalesced behind a held call (each must match ``predict``
    on its own frame and not on the other's), then a timed window of
    320 requests with every graph captured (requests/s, latency p50/p90
    and K1 launches per request from this window, which must capture
    nothing), and a camcalib_every=3 client (two named streams and
    header-less requests); /healthz, /stats counting every request,
    frame and person, every response held to ``predict`` on the same
    frames within same-card limits (SERVE_LIMITS). The window's K1
    launches are in the kernels line's ``launches_by_path``;
13. eval at full width (ResNet-50 HMR with camera features, three
    synthetic V = 6890 asset sets for gendered GT, 224² crops): the eval
    step at ``bench.py``'s eval inputs (B = 128, bf16) replayed against
    its eager body bit for bit, with 4 K1 launches per replay (printed,
    and the profiler's count), its wall ms and device ops per step, and
    a line saying that Procrustes runs outside the graph; the step on
    the card against the CPU in fp32 at B = 8 (vertices within 1e-5 m,
    metrics within 0.05 mm); ``evaluate_dataset`` over 300 in-memory
    samples in batches of 128 (the last padded, 44 valid) and
    ``compute_error`` with the j14 and j24 protocols (two chunks of
    256), card against CPU within 0.05 mm, with their K1 launches; the
    ``--help`` of ``spec_eval``, ``compute_error`` and
    ``annotate_camcalib`` (they import without cv2, PIL or PyYAML); and
    ``python -m spec_tpu_torch.bench --mode eval`` once;
14. train at full width (this slice's path): the SPEC train step
    (``train/steps.make_spec_train_step``) at ``bench.py``'s train setup
    (B = 64 crops of 224², ResNet-50 HMR with camera features, bf16,
    V = 6890, Adam 1e-4, zeroed decoders): a replay held to the eager
    body from one state (cuDNN deterministic, dropout off), then
    TRAIN_STEPS steps with dropout from a generator registered with the
    graph: a finite, falling loss and 2 K1 launches per replay (the
    kernels line's ``launches``, beside K1's phase-6 times at the same
    B = 64), graph and eager ms per step and the
    replay's device profile; card against CPU over five fp32 steps at
    the ``train_steps`` golden's size; K1's gradient inside the step
    against autograd through its plain version; K1's own work per step
    at B = 64 (two forwards, the closed-form backward); ``SpecTrainer``
    over in-memory samples (fit, checkpoint, resume in a sibling run,
    ``spec_eval``'s loader reading the checkpoint back); ``spec_train
    --help``; ``python -m spec_tpu_torch.bench --mode train --profile``,
    with and without ``--eager``;
15. CamCalib training at the released recipe
    (``configs/camcalib/config_sa_bias_l2.yaml``: ResNet-50, one FC layer,
    softargmax biased-L2 at weights 10, Adam 1e-3, fp32, MIN_RES 600,
    MAX_RES 1000) on in-memory uint8 frames of 480x640 (resized to
    600x800, bucket 640x832) and 720x1280 (562x1000, bucket 576x1024):
    a replay of ``train/steps.make_camcalib_train_step`` held to its
    eager body bit for bit, with fp32 batches and with DEVICE_JITTER
    uint8 batches; ``cli/camcalib_train.train``'s epoch loop at the
    recipe's batch of 4 (two buckets, two steps an epoch, validation MAE
    in degrees, checkpoints), preempted after one step and resumed in a
    sibling run that skips that batch; three fp32 steps on the card
    against the CPU (ResNet-18, 64x96 frames); ms per step at B = 16 in
    bucket 640x832 as a replay and eagerly, device busy, idle share and
    peak memory; ``camcalib_train --help``;
16. SMPLify (``train/smplify.smplify_fit``) at B = 64, 100 iterations,
    V = 6890, keypoints projected from a perturbed pose: one graph
    replay per fit held to its eager body bit for bit, the reprojection
    loss falling, K1's launches per replay (the wrapper's count and the
    profiler's, 101), ms per fit with its top device operations, K1's
    forward time and its backward's (measured alone, times 100) against
    the backward's bound; card against CPU at B = 8 and 10 iterations;
    ``SpecTrainer`` with RUN_SMPLIFY over in-memory samples, with the
    fits it accepted;
17. REMAT at the bench's train setup (B = 64, ResNet-50, bf16): two
    steps with and without ``remat`` from the same init, the losses,
    parameters and BatchNorm statistics compared (bit for bit with cuDNN
    deterministic), ms per step and peak memory both ways, then
    ``python -m spec_tpu_torch.bench --mode train --remat`` once;
18. the detector (run after phase 5, so that phase 6 times K1 at its
    path's batch): ``models/detector.YoloDetector`` at 416² in bf16, its
    batch of 8 and the tail ladder 4, 2, 1, each replay held to the
    eager body bit for bit; YOLOv3 in fp32 on the card against the CPU
    (B = 2, the whole decode, every row at its fixed index, within 1e-3
    of max(1, max |CPU|)); ``SpecPredictor(detector='yolo')`` at full
    ResNet-50 width, bf16, ``predict(frames)`` without boxes on phase 4's
    four 720x1280 frames (the random-init detector's threshold, a
    host-only knob, just under the weakest frame's best score, so every
    frame yields a box): persons per frame, K1's launches in the call
    (the kernels line's ``launches``: this slice's path), the replay
    against the eager stages and detector, the same results as
    ``predict(frames, boxes=detect(frames))`` bit for bit, ms per call
    both ways and its device profile; ``bench --mode detect`` at B = 32
    (img/s, ms per batch, the bound from YOLOv3's 65.9 GFLOP per image);
19. HRNet: HMR with ``hrnet_w32-conv`` in the predictor's stage 2 (bf16,
    phase 4's input): replay against eager, K1 launches per call, ms per
    call and stage 2 alone, the device profile; card against CPU at
    phase 8's small setup and limits with HRNet in stage 2 (its
    BatchNorm statistics set from one batch of random crops, so a random
    HRNet's activations stay near unit scale); the SPEC
    train step with the HRNet HMR at the train phase's B = 64 (bf16):
    replay against eager from one state, K1 launches over three replays,
    ms per step, peak memory, the device profile;
20. render (the host renderer over meshes K1 computed on the card;
    ``csrc/raster.cpp`` built with ``g++`` in phase 2, beside the
    kernels): (a) phase 4's full-width predictor in bf16 on its four
    720x1280 frames, then ``utils/renderer.render_mesh_overlay`` per
    frame (the demos' overlay): every person's mesh covers pixels, K1's
    launches on this path (the kernels line's ``launches``), ms per
    frame (median of 10) with the OpenMP thread count and the raster
    library's build seconds; the overlays from the card's fp32 outputs
    and the CPU's (the same weights) differ in at most RENDER_PIXEL_SHARE
    of each frame's mesh pixels; (b) phase 13's eval step at B = 128
    (bf16) and ``eval_loop.render_val_group`` without a file (the
    arrays ``save_images`` writes; the card machine has no cv2 to write
    JPEGs): the (224, 672, 3) layout of tests/test_renderer.py, a mesh
    in the overlay and side panels; (c) ``SpecTrainer.
    _train_image_summary`` (the summary forward through K1, then
    ``render_tb_grid``) into a stand-in writer: a (3, 4 x 224, 5 x 224)
    grid with meshes; (d) one ``predict`` under ``utils/profiling.trace``
    with ``annotate`` regions: the trace file holds the region names and
    K1's kernel; then whether ``g++ -fopenmp`` links here and whether
    ``jpeglib.h`` is found (the JPEG half of the host code is held on
    the CPU by tests/test_torch_native_loader.py);
21. export (``spec_tpu_torch/export.py``): phase 4's full-width predictor
    in fp32 and bf16, exported with ``torch.export`` on the card and once
    more on the CPU (the same seeds, so the same weights; the CPU's trace
    carries K1's op, which runs its plain version there), both artifacts
    loaded on the card with ``load_predictor`` (stages replaying CUDA
    graphs) and held to the live predictor on phase 4's four 720x1280
    frames within phase 8's limits (PREDICT_LIMITS, ANGLE_LIMIT); export
    and load seconds, artifact MiB, the symbolic ranges torch.export
    gave, ms per ``predict`` live and loaded (median of 10), K1's
    launches in one call of each loaded predictor, which must be above
    0 (the kernels line's ``launches`` is the CPU-exported fp32
    artifact's);
22. datagen: ``datagen/spec_synth.render_spec_synth_dataset`` at its
    CLI's defaults (n = 256, 256x320, f_pix 400) with SMPL on the card
    (one K1 launch over all 256 samples) and an in-memory frame writer,
    held to the same call on the CPU: the npz columns within
    SYNTH_LIMITS (the rest equal), the frames by the share of differing
    mesh pixels (RENDER_PIXEL_SHARE); ms for SMPL and the projection,
    ms per rendered frame, K1's launches (``launches_by_path
    ['spec_synth']``), and whether cv2, joblib and requests import here:
    where cv2 and joblib do, both Pano360 generators cut PANO_CROPS crops
    from one panorama (ms per crop);
23. parallel (``spec_tpu_torch/parallel``, data parallelism over
    ``torch.distributed``): (a) two ranks over gloo on the one card (two
    processes of this script, ``--parallel-rank``), each the SPEC train
    step at full width (ResNet-50 HMR, bf16, V = 6890) on its half of a
    global batch of PAR_BATCH crops whose halves hold different
    has_smpl and has_pose_3d counts, PAR_STEPS SGD steps: the losses and
    parameters held to one process stepping the global batch
    (PAR_LOSS_RTOL, PAR_UPDATE_RTOL), the ranks equal to each other,
    ms per step, K1's launches per rank and the gradient all-reduce's
    ms alone; (b) one rank over NCCL: the step is one graph replay with
    its all-reduces captured and equals the step without a process
    group bit for bit, its replay ms beside the plain step's, the NCCL
    kernels a replay's profile names; (c) ``SpecPredictor(data_parallel=
    True)`` at full width on phase 4's input, the card's own device list
    (one replica) bit for bit against the plain predictor, then the
    device-list seam giving two replicas on the one card (the split and
    the gather on it) within phase 8's fp32 limits, K1 launching once
    per replica (``launches_by_path``); (d) ``spec_eval
    --data_parallel``, ``serve --data_parallel`` (one request, SIGTERM)
    and ``spec_train`` with two ranks over gloo for one step, each its
    own process on tiny inputs (cv2 writes the frames), each exiting 0;
24. prints the kernels line and, last, ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` runs phases 1-2 and then, instead of
the rest, profiles phase 4's predictor (wall medians per stage, device
busy time, idle share, device operations and host launch calls, and the
top device operations, fp32 and bf16) and phase 5's pipeline with each
stage-1 trunk, each replaying its graphs and, for comparison, with its
eager stage bodies.
``python3 chip_smoke.py --render`` runs phases 1-2 and then phase 20
alone; ``python3 chip_smoke.py --export`` runs phases 1-2 and then
phases 21 and 22; ``python3 chip_smoke.py --parallel`` runs phases 1-2
and then phase 23.
``python3 chip_smoke.py --k3-tiles`` runs phases 1-2 and then times K3
in fp32 and bf16 at each stage shape with every candidate output tile
forced, beside the tile the kernel picks.
``python3 chip_smoke.py --k3-ab PARENT`` runs phases 1-2, builds the
bottleneck kernel of another checkout (``PARENT``, e.g. the parent
commit unpacked by ``git archive``) beside this one, and at phase 3's
shapes holds both to the plain version, compares their bf16 outputs bit
for bit and times them in turns (parent, this, this, parent).

Needs no network and no files beyond the checkout; builds go to
``build/spec_tpu_torch/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LBS_BATCHES = (1, 3, 8, 16, 32, 64, 128, 256)   # 256: compute_error's chunk
LBS_BUDGET = 1e-5          # m, the fused kernel's budget vs fp32
FRAME_HW = (720, 1280)
PERSONS_PER_FRAME = (1, 2, 3, 2)
BATCH_SIZE = 32
KERNELS = ('lbs', 'bottleneck', 'projection')
HOST_LIBS = ('raster',)      # g++ (the JPEG engine is held on the CPU)
# Render phase: the card's fp32 overlay against the CPU's may differ in
# at most this share of a frame's mesh pixels (edge pixels whose centre
# lies within the vertices' card-vs-CPU difference of a triangle edge).
RENDER_PIXEL_SHARE = 5e-3
RENDER_BACKBONE = 'resnet50'
RENDER_TIMING_CALLS = 10
RENDER_MIN_SIZE = 600
# The pipeline's input: bench.py's default stage-1 bucket, 16 frames;
# the bench's batch of frames.
PIPE_FRAMES, PIPE_HW = 16, (512, 672)
BENCH_BATCH = 128
# ResNet-50 identity blocks on PIPE_HW: (H, W, C, M, blocks in the stage).
RESNET50_STAGES = ((128, 168, 256, 64, 2), (64, 84, 512, 128, 3),
                   (32, 42, 1024, 256, 5), (16, 21, 2048, 512, 2))
ODD_SHAPE = (2, 13, 11, 256, 64, 3)       # B, H, W, C, M, chain length
# K3 budgets, relative to max(1, max |plain|): fp32, the plain version
# in exact fp32 and the kernel in 3xTF32 (each product within about 2^-21
# of fp32's) with its sums in another order; bf16 about two bf16 steps
# at the largest value (sums that land near a rounding boundary of h1,
# h2 or y round the other way on one side).
K3_BUDGET = {'fp32': 1e-4, 'bf16': 2.0 ** -6}
K2_BUDGET = 1e-2           # px (TPU_CHECKS_r05.json)
# K1's gradient against autograd of its plain version, relative to the
# largest entry of each cotangent (TPU_CHECKS_r05.json's budget).
LBS_GRAD_BUDGET = 1e-4
# The serve phase: frames of SERVE_HW (a VGA camera's), eight concurrent
# clients; SERVE_WARMUP requests at once (the first rounds capture graphs
# under load), then a timed window of SERVE_WINDOW requests (cycling
# SERVE_DISTINCT bodies) with every graph already captured.
SERVE_HW, SERVE_CLIENTS = (480, 640), 8
SERVE_WARMUP, SERVE_WINDOW, SERVE_DISTINCT = 24, 320, 80
# A /predict response against ``predict`` on the same frames, on the same
# card with the same weights: only the padded batch, and so cuDNN's choice
# of algorithm, differs. About ten times the largest difference seen over
# 24 served requests (NVIDIA H100 80GB HBM3, 700 W): pose, shape and
# camera 2-4e-7, cam_t 8.6e-6 m, vertices 6.3e-7 m, joints2d 9.2e-5 px,
# angles 1.1e-6 rad.
SERVE_LIMITS = dict(pred_pose=1e-5, pred_pose_6d=1e-5, pred_shape=1e-5,
                    pred_cam=1e-5, pred_cam_t=1e-4, smpl_vertices=1e-5,
                    smpl_joints3d=1e-5, smpl_joints2d=1e-3)
SERVE_ANGLE_LIMIT = 1e-5   # rad
# The eval phase: the eval step at bench.py's eval_bench inputs (B = 128
# crops of 224^2, ResNet-50, bf16, gendered GT over three synthetic asset
# sets), card against CPU in fp32 at EVAL_CPU_BATCH, and evaluate_dataset
# over EVAL_SAMPLES in-memory samples (three batches of 128, the last
# padded) followed by compute_error (two chunks of 256). Card vs CPU:
# metrics within 0.05 mm (TPU_CHECKS_r05.json's Procrustes budget),
# vertices within LBS_BUDGET.
EVAL_BATCH, EVAL_CPU_BATCH, EVAL_SAMPLES = 128, 8, 300
EVAL_BACKBONE, EVAL_RES = 'resnet50', 224
EVAL_MM = 0.05
EVAL_K1_PER_STEP = 4       # the model's SMPL, GT male and female, pred J24
# The train phase: the SPEC train step at bench.py's train_bench setup
# (B = 64 crops of 224^2, ResNet-50 HMR with camera features, bf16,
# V = 6890, Adam 1e-4, zeroed decoders) for TRAIN_STEPS graph replays;
# card against CPU over TRAIN_CPU_STEPS fp32 steps at the train_steps
# golden's size (ResNet-18, B = 4, 64^2, V = 128, Adam 1e-5, dropout
# off; the CPU parity test's limits: every loss term within 1e-4
# relative, the whole model within 1e-4 relative); K1's gradient inside
# the step at TRAIN_GRAD_BATCH (fp32, V = 6890) against autograd of its
# plain version, each parameter's gradient within LBS_GRAD_BUDGET of its
# largest entry; and SpecTrainer over TRAINER_SAMPLES in-memory samples
# in batches of TRAINER_BATCH. Replay against eager from one state, with
# cuDNN deterministic and dropout off: the losses within 1e-6 relative
# and the whole model within 1e-4 relative after the step (Adam moves an
# entry by about lr whatever its gradient's size, so bf16 gradients
# that differ in their last bits can flip a few entries).
TRAIN_BATCH, TRAIN_BACKBONE, TRAIN_RES, TRAIN_STEPS = 64, 'resnet50', 224, 10
TRAIN_K1_PER_STEP = 2      # GT mesh (no grad), predicted mesh (with grad)
TRAIN_CPU = dict(batch=4, res=64, vertices=128, backbone='resnet18',
                 steps=5, lr=1e-5)
TRAIN_LOSS_RTOL, TRAIN_MODEL_RTOL = 1e-4, 1e-4
TRAIN_REPLAY_LOSS_RTOL, TRAIN_REPLAY_MODEL_RTOL = 1e-6, 1e-4
TRAIN_GRAD_BATCH = 8
TRAINER_BACKBONE, TRAINER_BATCH, TRAINER_SAMPLES = 'resnet50', 8, 24
# One H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): the
# rate for each kernel's arithmetic (K3 on the tensor cores, bf16 or
# TF32, the fp32 variant as three TF32 products per fp32 one; K1 and K2
# on the CUDA cores in fp32) and the HBM rate.
PEAK_FLOPS = {'bf16': 989e12, 'tf32': 494.7e12, 'fp32': 67e12}
HBM_BYTES_PER_S = 3.35e12
K3_TILES = ((8, 16), (16, 8), (8, 8), (8, 7), (7, 8), (8, 6), (6, 8),
            (4, 8), (8, 4), (4, 4))
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


def _kernel_ms(fn, kernel, n=50, warmup=5, flush=None):
    """The kernel's own device time and the device work of one call.

    Runs ``fn()`` ``n`` times under torch.profiler, with the L2 cache
    flushed before each call when ``flush`` is given, and returns the
    median duration (ms) of the device kernels whose name contains
    ``kernel``: the wrapper's host work lies outside every such interval.
    A second, unflushed profile of ``n`` calls gives the device
    operations per call. Returns (ms, device ops per call). A profile
    that names fewer launches than calls (the tracer dropped an event:
    the wrapper counts every launch it makes) is taken once more; a
    second short one raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_events(flushed):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flushed:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    for attempt in range(2):
        durs = [(e.time_range.end - e.time_range.start) / 1e3
                for e in device_events(flush is not None)
                if kernel in e.name]
        if len(durs) == n:
            break
        print(f'[profile] the profiler saw {len(durs)} launches of '
              f'{kernel!r} in {n} calls' + ('; profiling again'
                                            if attempt == 0 else ''),
              flush=True)
    else:
        raise RuntimeError(f'the profiler saw {len(durs)} launches of '
                           f'{kernel!r} in {n} calls, twice')
    ops = len(device_events(False)) / n
    return statistics.median(durs), ops


def _queued_ms(fn, n=10, reps=3, warmup=2):
    """Device ms per call of ``fn()`` with ``n`` calls queued back to back
    between two CUDA events (so the host's time to issue a call hides
    behind the previous call), the median of ``reps`` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _cast_chain(ws, dtype):
    """A chain's weights in ``dtype`` and its biases in fp32, as
    FusedResNet holds them (so a timed call casts nothing)."""
    return tuple(tuple(t.float() if i % 2 else t.to(dtype)
                       for i, t in enumerate(block)) for block in ws)


def _bound(flops, nbytes, peak):
    """The least time (ms) the card could take for ``flops`` operations at
    ``peak`` and ``nbytes`` of traffic at the HBM rate, and which of the
    two bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def _k3_work(B, H, W, C, M, elem):
    """Operations and bytes of one identity bottleneck: 2 x pixels x
    (2 C M + 9 M^2) products; x read and y written once, the weights
    (in x's type) and fp32 biases read once."""
    flops = 2.0 * B * H * W * (2 * C * M + 9 * M * M)
    nbytes = (2 * B * H * W * C + 2 * C * M + 9 * M * M) * elem + \
        4 * (2 * M + C)
    return flops, nbytes


def _k3_bound(tag, flops, nbytes):
    """K3's bound: bf16 products at the bf16 rate; fp32 ones as 3xTF32,
    three TF32 products each at the TF32 rate."""
    if tag == 'fp32':
        return _bound(3 * flops, nbytes, PEAK_FLOPS['tf32'])
    return _bound(flops, nbytes, PEAK_FLOPS['bf16'])


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
    import concurrent.futures

    from spec_tpu_torch.ops.cuda_build import (
        build_host_library,
        build_libraries,
    )

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(HOST_LIBS)) as ex:
        host = dict(zip(HOST_LIBS, ex.map(build_host_library, HOST_LIBS)))
        built = build_libraries(KERNELS)
    print(f'[build] {len(KERNELS)} kernels (nvcc) and {len(HOST_LIBS)} '
          f'host librar{"y" if len(HOST_LIBS) == 1 else "ies"} (g++) in '
          f'parallel: {time.perf_counter() - t0:.2f} s wall')
    for name, (path, _, seconds) in host.items():
        print(f'[build] {path.name} (g++ -O3 -march=native -fopenmp) in '
              f'{seconds:.2f} s')
    for name, (path, log, seconds) in built.items():
        print(f'[build] {path.name} in {seconds:.2f} s')
        for ln in log.splitlines():
            if 'registers' in ln or 'spill' in ln:
                print(f'[build] {name}: {ln.strip()}')
    return {name: seconds for name, (_, _, seconds) in host.items()}


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
            call = lambda: L.fused_lbs_vertices(   # noqa: E731
                packed, coeffs, rel_tf)
            ms, ops = _kernel_ms(call, 'lbs_kernel', flush=flush)
            wrapper_ms = _wall_ms(call, 50)
            plain_ms = _time_ms(lambda: L.fused_lbs_vertices_plain(
                packed, coeffs, rel_tf), flush=flush)
            # Per vertex and row: 218 x 3 blendshape products, 24 x 12
            # skinning products, the 3x4 transform; fp32 on CUDA cores.
            # Bytes: the V vertices' columns of dirs and weights_t (not
            # the padding to Vp), coeffs, rel_tf and the output.
            n_coef, V = packed.dirs.shape[1], packed.num_vertices
            flops = 2.0 * B * V * (3 * n_coef + 24 * 12 + 12)
            nbytes = 4 * (3 * n_coef * V + 24 * V + coeffs.numel()
                          + rel_tf.numel() + out.numel())
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_FLOPS['fp32'])
            rows[B] = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            print(f'[lbs] B={B} V=6890 max_abs_err={err:.3e} m '
                  f'kernel={ms:.4f} ms (profiler, median of 50, L2 '
                  f'flushed) wrapper={wrapper_ms:.4f} ms per call (host '
                  f'wall with a sync, median of 50) device_ops={ops:g} per '
                  f'call plain={plain_ms:.4f} ms (events, median of 50, L2 '
                  f'flushed); bound {bound_ms:.4f} ms ({bound_by}, '
                  f'{nbytes / 1e6:.1f} MB), share of bound '
                  f'{bound_ms / ms:.3f}', flush=True)
    return rows


def _k3_operands(B, H, W, C, M, k, seed, dtype):
    """The card tests' operands; at the bench's batch x is drawn on the
    card (a host draw of 704 M values takes seconds)."""
    import torch

    # The card tests' helper (tests/ is put on sys.path by main).
    from test_torch_cuda_bottleneck import random_chain

    if B <= PIPE_FRAMES:
        return random_chain(B, H, W, C, M, k, seed=seed, dtype=dtype,
                            device='cuda')
    _, ws = random_chain(1, 4, 4, C, M, k, seed=seed, dtype=dtype,
                         device='cuda')
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.relu(torch.randn(B, H, W, C, generator=g, device='cuda'))
    return x.to(dtype), ws


def phase_bottleneck():
    """K3 vs its plain version at the pipeline's identity-block shapes
    (and layer1 at the bench's batch of 128, past 2^31 bytes of x in
    fp32), and the time of one block at B = 16: kernel, plain version,
    cuDNN module."""
    import torch

    from spec_tpu_torch.models.backbones.resnet import Bottleneck
    from spec_tpu_torch.ops import bottleneck as TB
    from spec_tpu_torch.utils.precision import fp32_precision

    rows = {}
    shapes = [(PIPE_FRAMES, H, W, C, M, 1)
              for H, W, C, M, _ in RESNET50_STAGES] + [ODD_SHAPE] + [
                  (BENCH_BATCH, *RESNET50_STAGES[0][:4], 1)]
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for si, (B, H, W, C, M, k) in enumerate(shapes):
            x, ws = _k3_operands(B, H, W, C, M, k, si, dtype)
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
            if k == 1 and B == PIPE_FRAMES:
                blk = Bottleneck(C, M).to('cuda').eval().to(
                    dtype=dtype, memory_format=torch.channels_last)
                nchw = x.permute(0, 3, 1, 2)
                wt = _cast_chain(ws, dtype)
                with torch.inference_mode(), fp32_precision():
                    row['ms'] = _queued_ms(
                        lambda: TB.fused_bottleneck_chain(x, wt))
                    row['plain_ms'] = _queued_ms(
                        lambda: TB.fused_bottleneck_chain_plain(x, wt))
                    row['cudnn_ms'] = _queued_ms(lambda: blk(nchw))
                    row['wrapper_ms'] = _wall_ms(
                        lambda: TB.fused_bottleneck_chain(x, wt), 50)
                flops, nbytes = _k3_work(B, H, W, C, M, x.element_size())
                row['bound_ms'], row['bound_by'] = _k3_bound(tag, flops,
                                                             nbytes)
                tile = TB.picked_tile(B, H, W, C, M, dtype)
                line += (f' kernel={row["ms"]:.4f} ms plain='
                         f'{row["plain_ms"]:.4f} ms cudnn_block='
                         f'{row["cudnn_ms"]:.4f} ms (10 queued calls, '
                         'median of 3); wrapper '
                         f'{row["wrapper_ms"]:.4f} ms per call (host wall '
                         'with a sync, median of 50); '
                         f'{flops / 1e9:.2f} GFLOP, kernel '
                         f'{flops / row["ms"] / 1e9:.1f} TFLOP/s, bound '
                         f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}), '
                         f'share of bound '
                         f'{row["bound_ms"] / row["ms"]:.3f}, tile '
                         f'{tile[0]}x{tile[1]} with {tile[2]} stages')
                del blk
            rows[tag, si] = row
            print(line, flush=True)
            del x, ws, out, ref
        torch.cuda.empty_cache()
    return rows


def phase_k3_tiles():
    """K3 in fp32 and bf16 at each stage shape with every candidate
    output tile forced (those whose shared memory fits), beside the tile
    the kernel picks: the readings behind the tile choice."""
    import torch

    from spec_tpu_torch.ops import bottleneck as TB

    from test_torch_cuda_bottleneck import random_chain

    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for si, (H, W, C, M, _) in enumerate(RESNET50_STAGES):
            B = PIPE_FRAMES
            x, ws = random_chain(B, H, W, C, M, 1, seed=si, dtype=dtype,
                                 device='cuda')
            block = _cast_chain(ws, dtype)[0]
            flops, _ = _k3_work(B, H, W, C, M, x.element_size())
            picked = TB.picked_tile(B, H, W, C, M, dtype)
            cells = []
            with torch.inference_mode():
                for tile in ((0, 0),) + K3_TILES:
                    try:
                        ms = _queued_ms(lambda: TB._launch(x, block, tile))
                    except RuntimeError:
                        cells.append(f'{tile[0]}x{tile[1]} does not fit')
                        continue
                    name = ('picked' if tile == (0, 0)
                            else f'{tile[0]}x{tile[1]}')
                    cells.append(f'{name} {ms:.4f} ms '
                                 f'{flops / ms / 1e9:.1f} TF/s')
            print(f'[k3 tiles {tag}] B={B} {H}x{W} C={C} M={M} picks '
                  f'{picked[0]}x{picked[1]} with {picked[2]} stages: '
                  + '; '.join(cells) + ' (10 queued calls, median of 3)',
                  flush=True)
            del x, ws
            torch.cuda.empty_cache()


def _chain_with(fn, x, ws):
    """The chain on the C entry ``fn``, block by block."""
    from spec_tpu_torch.ops import bottleneck as TB

    for block in ws:
        x = TB._launch(x, block, fn=fn)
    return x


def phase_k3_ab(parent):
    """K3 of the checkout at ``parent`` against this one's, in one
    process, at phase 3's shapes in fp32 and bf16: both held to the plain
    version, bf16 outputs compared bit for bit (raises if they differ),
    and the stage shapes timed in turns parent, this, this, parent (10
    queued calls, median of 3 each), beside cuDNN's Bottleneck."""
    import ctypes

    import torch

    from spec_tpu_torch.models.backbones.resnet import Bottleneck
    from spec_tpu_torch.ops import bottleneck as TB
    from spec_tpu_torch.ops import cuda_build as CB
    from spec_tpu_torch.utils.precision import fp32_precision

    from test_torch_cuda_bottleneck import random_chain

    src = Path(parent).resolve() / 'spec_tpu_torch' / 'csrc' / 'bottleneck.cu'
    lib = CB.BUILD_DIR / 'parent' / 'libbottleneck.so'
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([CB._nvcc(), *CB.NVCC_FLAGS, '-o', str(lib), str(src)],
                   check=True, capture_output=True, timeout=600)
    fns = {'parent': TB.bind_forward(ctypes.CDLL(str(lib))),
           'this': TB._kernel()}
    shapes = [(PIPE_FRAMES, H, W, C, M, 1)
              for H, W, C, M, _ in RESNET50_STAGES] + [ODD_SHAPE]
    differ = []
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for si, (B, H, W, C, M, k) in enumerate(shapes):
            x, ws = random_chain(B, H, W, C, M, k, seed=si, dtype=dtype,
                                 device='cuda')
            wt = _cast_chain(ws, dtype)
            with torch.inference_mode():
                outs = {n: _chain_with(fn, x, wt) for n, fn in fns.items()}
                ref = TB.fused_bottleneck_chain_plain(x, ws).float()
            scale = max(1.0, ref.abs().max().item())
            errs = {n: (o.float() - ref).abs().max().item() / scale
                    for n, o in outs.items()}
            same = torch.equal(outs['parent'], outs['this'])
            line = (f'[k3 ab {tag}] B={B} {H}x{W} C={C} M={M} k={k}: '
                    f'error / max(1, |plain|) parent {errs["parent"]:.3e} '
                    f'this {errs["this"]:.3e}; outputs bit-identical '
                    f'{same}')
            if tag == 'bf16' and not same:
                differ.append((B, H, W, C, M, k))
            if k == 1:
                ms = {'parent': [], 'this': []}
                with torch.inference_mode():
                    for n in ('parent', 'this', 'this', 'parent'):
                        ms[n].append(_queued_ms(
                            lambda: _chain_with(fns[n], x, wt)))
                    blk = Bottleneck(C, M).to('cuda').eval().to(
                        dtype=dtype, memory_format=torch.channels_last)
                    nchw = x.permute(0, 3, 1, 2)
                    with fp32_precision():
                        cudnn = _queued_ms(lambda: blk(nchw))
                flops, nbytes = _k3_work(B, H, W, C, M, x.element_size())
                bound, by = _k3_bound(tag, flops, nbytes)
                best = min(ms['this'])
                line += (f'; parent {ms["parent"][0]:.4f} / '
                         f'{ms["parent"][1]:.4f} ms, this '
                         f'{ms["this"][0]:.4f} / {ms["this"][1]:.4f} ms '
                         f'(turns 1, 4 / 2, 3; 10 queued calls, median of '
                         f'3), cudnn_block {cudnn:.4f} ms; this '
                         f'{flops / best / 1e9:.1f} TFLOP/s, bound '
                         f'{bound:.4f} ms ({by}), share of bound '
                         f'{bound / best:.3f}')
                del blk
            print(line, flush=True)
            del x, ws, wt, outs, ref
            torch.cuda.empty_cache()
    if differ:
        raise RuntimeError(f'bf16 K3 outputs differ from the parent at '
                           f'{differ}')


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


def _device_profile(label, fn, call_ms, n_prof, top=0):
    """torch.profiler over ``n_prof`` calls of ``fn``
    (``spec_tpu_torch.bench.device_profile``): prints the device busy
    time per call (union of the kernel and copy intervals), the idle
    share (1 - busy per call / ``call_ms``, the unprofiled call median),
    the device operations and the host's launch calls per call, the
    launches of K1 and K3 the profiler names, K3's device time per call
    and the ``top`` device operations by time. Returns the profile."""
    from spec_tpu_torch.bench import device_profile

    prof = device_profile(fn, n_prof)
    by_name, counts = prof['by_name'], prof['count_by_name']

    def count(kernel):
        return sum(n for name, n in counts.items() if kernel in name)

    print(f'[profile {label}] device busy {prof["busy_ms"]:.3f} ms per '
          f'call; {prof["device_ops"]:.0f} device ops and '
          f'{prof["host_launches"]:.0f} host launch calls per call; idle '
          f'share {1.0 - prof["busy_ms"] / call_ms:.3f}; lbs_kernel '
          f'{count("lbs_kernel"):g}, bottleneck_tc_kernel '
          f'{count("bottleneck_tc_kernel"):g} per call', flush=True)
    total = sum(by_name.values())
    k3 = sum(ms for name, ms in by_name.items() if 'bottleneck' in name)
    if k3:
        print(f'[profile {label}] K3 (bottleneck kernels) {k3:.3f} ms per '
              f'call ({k3 / total:.1%} of device time)')
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f'[profile {label}]   {ms:8.3f} ms per call '
              f'({ms / total:6.1%})  {name[:110]}')
    host = sorted(prof['host_by_name'].items(), key=lambda kv: -kv[1])
    if top:
        print(f'[profile {label}] host: ' + '; '.join(
            f'{name[:40]} {ms:.3f} ms' for name, ms in host[:top])
            + ' per call (self time)')
    prof['lbs_kernel'] = count('lbs_kernel')
    prof['bottleneck_tc_kernel'] = count('bottleneck_tc_kernel')
    return prof


@contextlib.contextmanager
def _eager(pred):
    """``pred``'s stages run their eager bodies (no graphs) inside."""
    stages = pred._stage1, pred._stage2
    pred._stage1, pred._stage2 = stages[0].fn, stages[1].fn
    try:
        yield
    finally:
        pred._stage1, pred._stage2 = stages


def _release():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_profile(n_wall=10, n_prof=3, top=8):
    """Where the time goes, in fp32 and bf16: (a) one ``predict`` call at
    phase 4's input, with the wall medians of the call, of stage 1 alone
    (``estimate_cameras``) and of stage 2 alone (``predict`` with the
    cameras given); (b) one call of phase 5's pipeline with each stage-1
    trunk. Each replays its graphs and is followed by
    :func:`_device_profile`; then the same call with the eager stage
    bodies, for comparison."""
    import torch

    from spec_tpu_torch.pipeline import build_pipeline

    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        pred = _full_width_predictor(dtype)
        cams = pred.estimate_cameras(frames)
        for mode in ('graphs', 'eager'):
            ctx = _eager(pred) if mode == 'eager' else contextlib.nullcontext()
            with ctx:
                call = _wall_ms(lambda: pred.predict(frames, boxes), n_wall)
                stage1 = _wall_ms(lambda: pred.estimate_cameras(frames),
                                  n_wall)
                stage2 = _wall_ms(
                    lambda: pred.predict(frames, boxes, cameras=cams), n_wall)
                label = f'{tag} {mode}'
                print(f'[profile {label}] predict median of {n_wall} '
                      f'{call:.3f} ms; stage 1 alone {stage1:.3f} ms; stage '
                      f'2 alone {stage2:.3f} ms')
                _device_profile(label, lambda: pred.predict(frames, boxes),
                                call, n_prof, top if mode == 'graphs' else 0)
        del pred
        _release()
    args = _pipeline_inputs(PIPE_FRAMES, PIPE_HW, seed=0, device='cuda')
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for stage1 in ('module', 'fused'):
            *_, pipeline = build_pipeline(compute_dtype=dtype,
                                          stage1=stage1, device='cuda')
            for mode, fn in (('graphs', pipeline), ('eager', pipeline.fn)):
                call = _wall_ms(lambda: fn(*args), n_wall)
                label = f'pipeline {tag} {stage1} {mode}'
                print(f'[profile {label}] call median of {n_wall} '
                      f'{call:.3f} ms')
                _device_profile(label, lambda: fn(*args), call, n_prof,
                                top if mode == 'graphs' else 0)
            del pipeline
            _release()


# Card vs CPU for the predictor (ResNet-18, fp32): limits per output,
# and on the camera angles (rad). The graphs phase holds bf16 replays to
# the pipelines' bf16 limits (CARD_VS_CPU below).
PREDICT_LIMITS = {
    'fp32': dict(pred_pose=2e-3, pred_pose_6d=2e-3, pred_shape=2e-3,
                 pred_cam=2e-3, pred_cam_t=2e-3, smpl_vertices=5e-3,
                 smpl_joints3d=5e-3, smpl_joints2d=0.1),
    'bf16': dict(pred_pose=1e-2, pred_pose_6d=1e-2, pred_shape=1e-2,
                 pred_cam=1e-2, pred_cam_t=1e-2, smpl_vertices=1e-2,
                 smpl_joints3d=1e-2, smpl_joints2d=0.5),
}
ANGLE_LIMIT = {'fp32': 1e-4, 'bf16': 1e-3}


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
    errs = {k: 0.0 for k in PREDICT_LIMITS['fp32']}
    for rg, rc in zip(res_g, res_c):
        for pg, pc in zip(rg, rc):
            for k in errs:
                errs[k] = max(errs[k], float(np.abs(pg[k] - pc[k]).max()))
    limits = PREDICT_LIMITS['fp32']
    print(f'[card vs cpu] resnet18 min_size 96 img_res 64: camera angles '
          f'{cam_err:.2e} rad (limit {ANGLE_LIMIT["fp32"]}), f_pix '
          f'{f_err:.2e} px (limit 0.05), '
          + ', '.join(f'{k} {v:.2e} (limit {limits[k]})'
                      for k, v in errs.items()))
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if cam_err > ANGLE_LIMIT['fp32'] or f_err > 0.05 or bad:
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


def _projection_operands(verts, cam_t, vfov, pitch, roll):
    """K2's operands for meshes (B, V, 3) seen by the pipeline's cameras:
    points, R (B, 3, 3), t (B, 3), K (B, 3, 3) on PIPE_HW frames."""
    import torch

    from spec_tpu_torch.core import geometry as G
    from spec_tpu_torch.utils.precision import fp32_precision

    B = verts.shape[0]
    h, w = (torch.full((B,), float(v), device='cuda') for v in PIPE_HW)
    with fp32_precision():
        R = G.euler_to_rotmat(
            torch.stack([pitch, torch.zeros_like(pitch), roll], -1))
        K = G.build_cam_intrinsics(G.focal_length_from_vfov(vfov, h), w, h)
    return verts.contiguous(), R, cam_t, K


def phase_projection(args):
    """K2 on ``args`` = (points, R, t, K), against its plain version and
    ``geometry.perspective_projection``, timed."""
    import torch

    from spec_tpu_torch.core import geometry as G
    from spec_tpu_torch.ops import projection as TP

    B = args[0].shape[0]
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
    call = lambda: TP.project_points(*args)     # noqa: E731
    ms, ops = _kernel_ms(call, 'project_kernel', flush=flush)
    wrapper_ms = _wall_ms(call, 50)
    plain_ms = _time_ms(lambda: TP.project_points_plain(*args), flush=flush)
    # Per vertex: the 3x4 camera matrix on [X, 1] and the divide.
    flops = 2.0 * B * 6890 * (12 + 1)
    nbytes = 4 * (sum(a.numel() for a in args) + pix.numel())
    bound_ms, bound_by = _bound(flops, nbytes, PEAK_FLOPS['fp32'])
    print(f'[projection] B={B} V=6890 max_abs_err={err:.3e} px vs plain and '
          f'perspective_projection (budget {K2_BUDGET}); kernel={ms:.4f} ms '
          f'(profiler, median of 50, L2 flushed) wrapper={wrapper_ms:.4f} '
          f'ms per call (host wall with a sync, median of 50) '
          f'device_ops={ops:g} per call plain={plain_ms:.4f} ms (events, '
          f'median of 50, L2 flushed); bound {bound_ms:.4f} ms ({bound_by}, '
          f'{nbytes / 1e6:.2f} MB), share of bound {bound_ms / ms:.3f}',
          flush=True)
    return dict(launches=launches, max_abs_err=err, ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


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


def _predict_diff(got, want):
    """Two ``predict(..., return_cameras=True)`` results: (bit for bit,
    {output: max |difference|} over every person, max camera angle
    difference)."""
    import numpy as np

    (res_g, cams_g), (res_w, cams_w) = got, want
    if [len(r) for r in res_g] != [len(r) for r in res_w]:
        raise RuntimeError('replay and eager differ in persons per frame')
    same, errs = True, {}
    for rg, rw in zip(res_g, res_w):
        for pg, pw in zip(rg, rw):
            for k, v in pg.items():
                if k == 'camera':
                    continue
                same = same and np.array_equal(v, pw[k])
                errs[k] = max(errs.get(k, 0.0),
                              float(np.abs(v - pw[k]).max()))
    cam = max(abs(g[k] - w[k]) for g, w in zip(cams_g, cams_w)
              for k in ('vfov', 'pitch', 'roll'))
    return same and cam == 0.0, errs, cam


def _hold_predict(label, got, want, tag):
    same, errs, cam = _predict_diff(got, want)
    limits = PREDICT_LIMITS[tag]
    print(f'[graphs {label}] replay vs eager: bit-identical {same}; camera '
          f'angles {cam:.2e} rad (limit {ANGLE_LIMIT[tag]}), '
          + ', '.join(f'{k} {errs[k]:.2e} (limit {lim})'
                      for k, lim in limits.items()), flush=True)
    bad = [k for k, lim in limits.items() if not errs[k] <= lim]
    if cam > ANGLE_LIMIT[tag] or bad:
        raise RuntimeError(f'{label}: replays disagree with the eager '
                           f'stages in {bad or "cameras"}')


def _graph_call(label, fn, lbs, k3):
    """Wall ms (median of 5) and the profile of one graph call; raises
    unless the profiler saw ``lbs`` K1 and ``k3`` K3 launches per call."""
    wall = _wall_ms(fn, 5)
    print(f'[graphs {label}] {wall:.3f} ms per call (median of 5)')
    prof = _device_profile(f'graphs {label}', fn, wall, 3)
    if (prof['lbs_kernel'], prof['bottleneck_tc_kernel']) != (lbs, k3):
        raise RuntimeError(f'{label}: the profiler saw '
                           f'{prof["lbs_kernel"]:g} lbs_kernel and '
                           f'{prof["bottleneck_tc_kernel"]:g} '
                           f'bottleneck_tc_kernel launches per call, '
                           f'expected {lbs} and {k3}')


def phase_graphs():
    """CUDA graph replays against the eager stage bodies, and the bench
    once per mode (see the module docstring, phase 9)."""
    import torch

    from spec_tpu_torch import bench
    from spec_tpu_torch.ops import bottleneck as TB
    from spec_tpu_torch.pipeline import build_pipeline

    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        pred = _full_width_predictor(dtype)
        pred.predict(frames, boxes)                     # capture
        got = pred.predict(frames, boxes, return_cameras=True)
        with _eager(pred):
            want = pred.predict(frames, boxes, return_cameras=True)
        _hold_predict(f'predict {tag}', got, want, tag)
        _graph_call(f'predict {tag}', lambda: pred.predict(frames, boxes),
                    lbs=1, k3=0)
        if tag == 'fp32':
            sf, sb = _frames_and_boxes(6, (1,), seed=1)
            pred.camcalib_every, pred.cut_threshold = 3, 0.0
            pred.predict(sf, sb, stream='capture')
            got = pred.predict(sf, sb, stream='graphs', return_cameras=True)
            with _eager(pred):
                want = pred.predict(sf, sb, stream='eager',
                                    return_cameras=True)
            _hold_predict('predict fp32 camcalib_every=3', got, want, tag)
            pred.camcalib_every = 1
            for n_frames in (10, 16):
                cf, cb = _frames_and_boxes(n_frames, (4,), seed=2)
                pred.predict(cf, cb)
                got = pred.predict(cf, cb, return_cameras=True)
                with _eager(pred):
                    want = pred.predict(cf, cb, return_cameras=True)
                n = 4 * n_frames
                _hold_predict(f'predict fp32 {n} persons (stage-2 chunks '
                              f'32 + {n - 32})', got, want, tag)
            padded = sorted(key[0][0][0] for key in pred._stage2.signatures())
            print(f'[graphs predict fp32] stage-2 graphs captured for '
                  f'padded batches {padded}')
            if 32 not in padded:
                raise RuntimeError('no stage-2 graph of 32 rows')
        del pred
        _release()

    args = _pipeline_inputs(PIPE_FRAMES, PIPE_HW, seed=0, device='cuda')
    names = ('vertices', 'joints2d', 'cam_t', 'vfov', 'pitch', 'roll')
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for stage1 in ('module', 'fused'):
            *_, pipeline = build_pipeline(compute_dtype=dtype,
                                          stage1=stage1, device='cuda')
            TB.LAUNCHES = 0
            want = pipeline.fn(*args)
            k3 = TB.LAUNCHES
            pipeline(*args)                                  # capture
            got = pipeline(*args)
            errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            label = f'pipeline {tag} {stage1}'
            print(f'[graphs {label}] replay vs eager: bit-identical {same}; '
                  + ', '.join(f'{n} {e:.2e} (limit {lim})' for n, e, lim
                              in zip(names, errs, CARD_VS_CPU[tag])),
                  flush=True)
            if not all(e <= lim for e, lim in zip(errs, CARD_VS_CPU[tag])):
                raise RuntimeError(f'{label}: replays disagree with the '
                                   'eager pipeline')
            _graph_call(label, lambda: pipeline(*args), lbs=1, k3=k3)
            del pipeline, got, want
            _release()

    for argv in (['--iters', '1'], ['--mode', 'serving', '--iters', '1'],
                 ['--mode', 'serving', '--compute_only', '--iters', '1'],
                 ['--mode', 'latency', '--iters', '2']):
        print(f'[graphs bench] python -m spec_tpu_torch.bench '
              f'{" ".join(argv)}', flush=True)
        if bench.main(argv) != 0:
            raise RuntimeError(f'the bench failed: {argv}')
        _release()


def phase_lbs_backward():
    """K1's gradient on the card: autograd through ``fused_lbs_vertices``
    (the kernel forward plus the closed-form backward) against autograd
    through ``fused_lbs_vertices_plain``, all four cotangents, at B = 1,
    8 and 32, each within LBS_GRAD_BUDGET of its largest entry."""
    import dataclasses

    import numpy as np
    import torch

    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.ops import lbs as L

    assets = S.create_test_assets().to('cuda')
    packed = L.pack_lbs_operands(assets).to('cuda')
    names = ('dirs', 'weights_t', 'coeffs', 'rel_tf')

    def grads(fn, coeffs, rel_tf, g):
        leaves = [packed.dirs.clone().requires_grad_(True),
                  packed.weights_t.clone().requires_grad_(True),
                  coeffs.clone().requires_grad_(True),
                  rel_tf.clone().requires_grad_(True)]
        out = fn(dataclasses.replace(packed, dirs=leaves[0],
                                     weights_t=leaves[1]),
                 leaves[2], leaves[3])
        return torch.autograd.grad(out, leaves, g)

    worst = 0.0
    for B in (1, 8, 32):
        coeffs, rel_tf = _lbs_operands(packed, assets, B, seed=100 + B)
        g = torch.from_numpy(np.random.RandomState(B).randn(
            B, 6890, 3).astype('f4')).cuda()
        got = grads(L.fused_lbs_vertices, coeffs, rel_tf, g)
        want = grads(L.fused_lbs_vertices_plain, coeffs, rel_tf, g)
        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got, want)]
        pad = max(got[0][..., 6890:].abs().max().item(),
                  got[1][:, 6890:].abs().max().item())
        ms = _wall_ms(lambda: grads(L.fused_lbs_vertices, coeffs, rel_tf, g),
                      10)
        plain_ms = _wall_ms(lambda: grads(L.fused_lbs_vertices_plain,
                                          coeffs, rel_tf, g), 10)
        worst = max(worst, *rel)
        print(f'[lbs backward] B={B}: relative max error to autograd of the '
              'plain version ' + ', '.join(
                  f'{n} {r:.2e}' for n, r in zip(names, rel))
              + f' (budget {LBS_GRAD_BUDGET:.0e}); padding {pad:g}; forward '
              f'+ backward {ms:.3f} ms (kernel + closed form) vs '
              f'{plain_ms:.3f} ms (plain autograd), host wall with a sync, '
              'median of 10', flush=True)
        if not (max(rel) <= LBS_GRAD_BUDGET and pad == 0.0):
            raise RuntimeError(f'K1 gradient disagrees at B={B}: {rel}, '
                               f'padding {pad}')
    return worst


def _synthetic_frames(n, hw, seed):
    """``n`` uint8 RGB frames of ``hw``: smooth gradients plus noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    frames = []
    for i in range(n):
        base = 110 + 60 * np.sin(xx / (70 + 5 * i)) * np.cos(yy / (60 + i))
        img = base[..., None] + rng.randint(-25, 26, (h, w, 3))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def phase_cli_devices():
    """The device functions the folder CLIs call after decoding, at full
    ResNet-50 width on the card and on the CPU (same seeds):
    camcalib_demo's stage 1 on a padded batch of 16 resized frames
    (480x640 -> 600x800), and spec_demo's stage 2 on crops cut on the
    device from two 480x640 frames, a chunk padded to the demo's 32."""
    import numpy as np
    import torch

    from spec_tpu_torch.cli import camcalib_demo, spec_demo
    from spec_tpu_torch.data.detection import bbox_to_center_scale
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.utils.cam_params import euler_pitch_roll_np

    resized = _synthetic_frames(4, (600, 800), seed=3)
    batch = torch.from_numpy(np.stack(resized + [resized[-1]] * 12))
    angles = {}
    for dev in ('cuda', 'cpu'):
        _, stage = camcalib_demo._get_model('', 'resnet50', 'softargmax_l2',
                                            dev)
        with torch.inference_mode():
            angles[dev] = stage(batch.to(dev))[-1].cpu().numpy()
    err = float(np.abs(angles['cuda'] - angles['cpu']).max())
    print(f'[cli camcalib_demo] stage 1, resnet50, 16 x 600x800: card vs '
          f'CPU angles {err:.2e} rad (limit {ANGLE_LIMIT["fp32"]})',
          flush=True)
    if not err <= ANGLE_LIMIT['fp32']:
        raise RuntimeError('camcalib_demo stage 1: card and CPU disagree')

    frames = dict(zip('ab', _synthetic_frames(2, (480, 640), seed=4)))
    boxes = {'a': [[200, 250, 150, 300], [420, 240, 120, 260],
                   [600, 100, 120, 200]], 'b': [[320, 240, 500, 460]]}
    chunk = []
    for key, bx in boxes.items():
        centers, scales = bbox_to_center_scale(np.asarray(bx, np.float32))
        K = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
        R = euler_pitch_roll_np(-0.12, 0.03)
        chunk += [(key, centers[i], scales[i], R, K, 640, 480)
                  for i in range(len(bx))]
    n_valid = len(chunk)
    chunk += [chunk[-1]] * (32 - n_valid)
    outs = {}
    for dev in ('cuda', 'cpu'):
        _, _, stage = spec_demo._get_spec_model('', '', '', 224, dev)
        frames_dev = {k: torch.from_numpy(v).to(dev)
                      for k, v in frames.items()}
        spec_demo.spec_on_crops(stage, frames_dev, chunk, 224)   # capture
        L.LAUNCHES = 0
        out = spec_demo.spec_on_crops(stage, frames_dev, chunk, 224)
        launches = L.LAUNCHES
        outs[dev] = {k: v[:n_valid].cpu().numpy() for k, v in out.items()}
        if dev == 'cuda' and launches != 1:
            raise RuntimeError(f'spec_demo stage 2 replay launched K1 '
                               f'{launches} times')
    limits = PREDICT_LIMITS['fp32']
    errs = {k: float(np.abs(outs['cuda'][k] - outs['cpu'][k]).max())
            for k in limits}
    print(f'[cli spec_demo] stage 2 on device crops, resnet50, {n_valid} '
          'persons in a chunk of 32: card vs CPU ' + ', '.join(
              f'{k} {v:.2e} (limit {limits[k]})' for k, v in errs.items()),
          flush=True)
    bad = [k for k in limits if not errs[k] <= limits[k]]
    if bad or not all(np.isfinite(v).all() for v in outs['cuda'].values()):
        raise RuntimeError(f'spec_demo stage 2: card and CPU disagree in '
                           f'{bad or "finiteness"}')
    _release()


def _npz_body(frames, boxes):
    """A /predict body: frame_i and boxes_i arrays in one npz."""
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **{f'{k}_{i}': v for i, (f, bx) in
                     enumerate(zip(frames, boxes))
                     for k, v in (('frame', f), ('boxes', bx))})
    return buf.getvalue()


def _serve_requests(n, seed, max_frames=2, max_boxes=4):
    """``n`` requests of 1..max_frames SERVE_HW uint8 frames with
    1..max_boxes person boxes each: (npz body, frames, boxes)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pool = _synthetic_frames(8, SERVE_HW, seed)
    h, w = SERVE_HW
    out = []
    for _ in range(n):
        frames, boxes = [], []
        for _ in range(rng.randint(1, max_frames + 1)):
            frames.append(np.roll(pool[rng.randint(len(pool))],
                                  rng.randint(0, w), axis=1))
            k = rng.randint(1, max_boxes + 1)
            bw = rng.uniform(80, 200, k)
            boxes.append(np.stack([rng.uniform(100, w - 100, k),
                                   rng.uniform(120, h - 120, k), bw,
                                   bw * rng.uniform(1.2, 2.0, k)],
                                  1).astype('f4'))
        out.append((_npz_body(frames, boxes), frames, boxes))
    return out


def _response_errors(label, resp, want_res, want_cams):
    """Max |difference| per output key and over the camera angles
    between a /predict response and ``predict``'s results; the frame and
    person counts must be equal."""
    import numpy as np

    errs = dict.fromkeys(SERVE_LIMITS, 0.0)
    cam_err = 0.0
    if int(resp['n_frames']) != len(want_res):
        raise RuntimeError(f'{label}: {int(resp["n_frames"])} frames')
    for fi, persons in enumerate(want_res):
        if int(resp[f'f{fi}_n_persons']) != len(persons):
            raise RuntimeError(f'{label}: frame {fi} persons')
        got_cam = resp[f'f{fi}_camera']
        cam_err = max(cam_err, *(abs(float(got_cam[i]) - want_cams[fi][k])
                                 for i, k in enumerate(('vfov', 'pitch',
                                                        'roll'))))
        for pi, person in enumerate(persons):
            for k in SERVE_LIMITS:
                got = resp[f'f{fi}_p{pi}_{k}']
                if not np.isfinite(got).all():
                    raise RuntimeError(f'{label}: non-finite {k}')
                errs[k] = max(errs[k], float(np.abs(got - person[k]).max()))
    return errs, cam_err


def _within_serve_limits(errs, cam_err):
    return (all(errs[k] <= SERVE_LIMITS[k] for k in SERVE_LIMITS)
            and cam_err <= SERVE_ANGLE_LIMIT)


def _hold_response(label, resp, want_res, want_cams):
    """A /predict response against ``predict``'s results on the same
    frames, within the same-card limits SERVE_LIMITS."""
    errs, cam_err = _response_errors(label, resp, want_res, want_cams)
    if not _within_serve_limits(errs, cam_err):
        raise RuntimeError(f'{label}: response and predict disagree: '
                           f'{errs}, camera {cam_err}')
    return errs, cam_err


def _serve_worst(label, pairs):
    """Holds every (response, (results, cameras)) pair and prints the
    largest difference per key beside its limit."""
    worst = dict.fromkeys(SERVE_LIMITS, 0.0)
    cam_worst = 0.0
    for resp, (res, cams) in pairs:
        errs, cam = _hold_response(label, resp, res, cams)
        worst = {k: max(worst[k], errs[k]) for k in worst}
        cam_worst = max(cam_worst, cam)
    print(f'[{label}] {len(pairs)} responses vs predict on their frames: '
          f'camera angles {cam_worst:.2e} rad (limit {SERVE_ANGLE_LIMIT}), '
          + ', '.join(f'{k} {v:.2e} (limit {SERVE_LIMITS[k]})'
                      for k, v in worst.items()), flush=True)


def phase_serve():
    """``python -m spec_tpu_torch.cli.serve``'s server, in-process on a
    free localhost port, over the full-width predictor that serve's
    default flags build (ResNet-50 x2, fp32, min_size 600, batch 32):

    (a) warm-up under load: SERVE_CLIENTS client threads POST
        SERVE_WARMUP requests at once (the first rounds capture their
        graphs with requests queued);
    (b) one request each of 1, 2, 4, ..., 32 frames (one box a frame),
        so every padded stage-1 and stage-2 batch a round can form has
        its graph;
    (c) coalescing: with the dispatcher held inside a call, two requests
        with different frames and boxes queue, then run as one call;
        each response must match ``predict`` on its own frames and not
        on the other's;
    (d) the timed window: the launch counts and captures set to 0, the
        clients POST SERVE_WINDOW requests; requests/s, latency p50/p90
        and K1 launches per request come from this window, which must
        take no capture;
    (e) a camcalib_every=3 client: named streams A and B and header-less
        requests.

    Checks /healthz and /stats (every request, frame and person counted;
    a coalesced round) and holds every response to ``predict`` on the
    same frames afterwards. Returns the K1 launches of the window."""
    import io
    import json
    import threading
    import urllib.request

    import numpy as np
    import torch

    from spec_tpu_torch.cli import serve
    from spec_tpu_torch.ops import lbs as L

    pred = serve.build_predictor(serve.parse_args([]), torch.device('cuda'))
    captures = []
    for stage in (pred._stage1, pred._stage2):
        def counting(key, args, fixed, orig=stage._capture,
                     name=stage.name):
            captures.append(name)
            return orig(key, args, fixed)
        stage._capture = counting
    server = serve.create_server(pred, host='127.0.0.1', port=0)
    base = f'http://127.0.0.1:{server.server_address[1]}'
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(body, stream=None):
        req = urllib.request.Request(base + '/predict', data=body)
        if stream:
            req.add_header('X-Spec-Stream', stream)
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            out = np.load(io.BytesIO(r.read()))
        return out, (time.perf_counter() - t0) * 1e3

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read()

    def stats():
        return json.loads(get('/stats'))

    def concurrently(bodies):
        """SERVE_CLIENTS threads post ``bodies`` (client c takes every
        SERVE_CLIENTS-th from c), all starting together: (responses,
        latencies in ms, wall s)."""
        responses, latency = [None] * len(bodies), [None] * len(bodies)
        errors = []
        start = threading.Barrier(SERVE_CLIENTS + 1)

        def client(c):
            start.wait()
            for i in range(c, len(bodies), SERVE_CLIENTS):
                try:
                    responses[i], latency[i] = post(bodies[i])
                except Exception as e:
                    errors.append(e)

        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in clients:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f'serve: {len(errors)} requests failed: '
                               f'{errors[0]}')
        return responses, latency, wall

    def counted(before, after, reqs, label):
        """/stats between two snapshots must count ``reqs`` exactly."""
        d = {k: after[k] - before[k] for k in ('requests_total',
                                               'frames_total',
                                               'persons_total', 'rounds_total',
                                               'calls_total',
                                               'request_errors')}
        want = (len(reqs), sum(len(r[1]) for r in reqs),
                sum(len(b) for r in reqs for b in r[2]), 0)
        if (d['requests_total'], d['frames_total'], d['persons_total'],
                d['request_errors']) != want:
            raise RuntimeError(f'{label}: /stats counted {d}, want '
                               f'(requests, frames, persons, errors) {want}')
        return d

    try:
        if get('/healthz') != b'ok':
            raise RuntimeError('/healthz did not answer ok')

        # (a) Warm-up under load.
        warm = _serve_requests(SERVE_WARMUP, seed=5)
        s0 = stats()
        responses, latency, wall = concurrently([r[0] for r in warm])
        s1 = stats()
        d = counted(s0, s1, warm, 'serve warm-up')
        if s1['max_round_frames'] < 2:
            raise RuntimeError('no warm-up round coalesced two or more '
                               'frames')
        print(f'[serve warm-up] {len(warm)} requests from {SERVE_CLIENTS} '
              f'concurrent clients in {wall:.3f} s with {len(captures)} '
              f'graph captures (stage1 {captures.count("stage1")}, stage2 '
              f'{captures.count("stage2")}); {d["rounds_total"]} rounds, '
              f'max_round_frames {s1["max_round_frames"]} (not a '
              'throughput figure: captures included)', flush=True)
        _serve_worst('serve warm-up', [
            (resp, pred.predict(r[1], r[2], return_cameras=True))
            for r, resp in zip(warm, responses)])

        # (b) Every padded batch size's graphs.
        fill = _serve_requests(1, seed=8, max_frames=1, max_boxes=1)[0]
        for n in (2 ** k for k in range(pred.batch_size.bit_length())):
            frames, boxes = fill[1] * n, fill[2] * n
            resp, _ = post(_npz_body(frames, boxes))
            if [int(resp[f'f{i}_n_persons']) for i in range(n)] != [1] * n:
                raise RuntimeError(f'serve: a {n}-frame request lost '
                                   'persons')
        print(f'[serve] graphs after the warm-up and one request each of '
              f'1, 2, 4, ..., {pred.batch_size} frames: stage1 '
              f'{len(pred._stage1.signatures())}, stage2 '
              f'{len(pred._stage2.signatures())}', flush=True)

        # (c) Two queued requests coalesce into one call, and each gets
        # its own persons back.
        pair = []
        for frame, bx in zip(_synthetic_frames(2, SERVE_HW, seed=9), (
                [[200, 240, 120, 220], [450, 260, 100, 200]],
                [[300, 200, 150, 260], [520, 300, 90, 180]])):
            boxes = [np.asarray(bx, np.float32)]
            pair.append((_npz_body([frame], boxes), [frame], boxes))
        entered, gate = threading.Event(), threading.Event()
        inner = pred.predict

        def held(*a, **kw):
            if not gate.is_set():
                entered.set()
                gate.wait(timeout=120)
            return inner(*a, **kw)

        got = [None, None, None]

        def send(i, body):
            got[i] = post(body)[0]

        s0 = stats()
        pred.predict = held
        try:
            senders = [threading.Thread(target=send,
                                        args=(0, pair[0][0]))]
            senders[0].start()
            if not entered.wait(timeout=120):
                raise RuntimeError('serve: the first request never '
                                   'reached predict')
            senders += [threading.Thread(target=send, args=(i + 1, b))
                        for i, (b, _, _) in enumerate(pair)]
            for t in senders[1:]:
                t.start()
            t_end = time.time() + 120
            while server.batcher.stats()['queue_depth'] < 2:
                if time.time() > t_end:
                    raise RuntimeError('serve: two requests never queued')
                time.sleep(0.005)
        finally:
            gate.set()
            for t in senders:
                t.join()
            del pred.predict
        d = counted(s0, stats(), [pair[0], pair[0], pair[1]],
                    'serve coalescing')
        if (d['rounds_total'], d['calls_total']) != (2, 2):
            raise RuntimeError(f'serve: two queued requests were not '
                               f'served by one call: {d}')
        direct = [pred.predict(f, bx, return_cameras=True)
                  for _, f, bx in pair]
        for i in (0, 1):
            _hold_response(f'serve coalesced request {i}', got[i + 1],
                           *direct[i])
            other = _response_errors(f'serve coalesced request {i}',
                                     got[i + 1], *direct[1 - i])
            if _within_serve_limits(*other):
                raise RuntimeError(f'serve: coalesced request {i} also '
                                   'matches the other request\'s persons')
        print('[serve coalescing] two requests (1 frame, 2 persons each) '
              'queued behind a held call and served by one call: each '
              'matches predict on its own frame within SERVE_LIMITS and '
              'differs from the other\'s beyond them', flush=True)

        # (d) The timed window, every graph captured.
        distinct = _serve_requests(SERVE_DISTINCT, seed=7)
        window = [distinct[i % SERVE_DISTINCT] for i in range(SERVE_WINDOW)]
        n_graphs = len(captures)
        s0 = stats()
        L.LAUNCHES = 0
        responses, latency, wall = concurrently([r[0] for r in window])
        launches = L.LAUNCHES
        s1 = stats()
        new_captures = len(captures) - n_graphs
        d = counted(s0, s1, window, 'serve window')
        print(f'[serve] window: {len(window)} requests ({d["frames_total"]} '
              f'frames {SERVE_HW[0]}x{SERVE_HW[1]}, {d["persons_total"]} '
              f'persons) from {SERVE_CLIENTS} concurrent clients in '
              f'{wall:.3f} s: {len(window) / wall:.2f} requests/s, '
              f'{d["frames_total"] / wall:.1f} frames/s, '
              f'{d["persons_total"] / wall:.1f} persons/s; latency p50 '
              f'{np.percentile(latency, 50):.1f} ms, p90 '
              f'{np.percentile(latency, 90):.1f} ms, mean '
              f'{np.mean(latency):.1f} ms, max {np.max(latency):.1f} ms; '
              f'{d["rounds_total"]} rounds, '
              f'{d["frames_total"] / d["rounds_total"]:.2f} frames a '
              f'round; K1 launches {launches} '
              f'({launches / len(window):.3f} per request, one per stage-2 '
              f'chunk replayed); graph captures in the window '
              f'{new_captures}', flush=True)
        if new_captures:
            raise RuntimeError(f'serve: the timed window captured '
                               f'{new_captures} graphs')
        if launches < 1:
            raise RuntimeError('serve never launched K1')
        want = [pred.predict(r[1], r[2], return_cameras=True)
                for r in distinct]
        _serve_worst('serve window', [
            (resp, want[i % SERVE_DISTINCT])
            for i, resp in enumerate(responses)])

        # (e) One client, camcalib_every=3: named streams A and B and
        # header-less requests, one frame each, interleaved.
        pred.camcalib_every, pred.cut_threshold = 3, 0.0
        seq = [('A', 0), ('B', 1), (None, 2), ('A', 3), ('A', 4), ('B', 5),
               (None, 6), ('A', 7)]
        stream_reqs = _serve_requests(len(seq), seed=6, max_frames=1)
        got = [post(stream_reqs[i][0], stream=s)[0] for s, i in seq]
        direct = []
        for s, i in seq:
            _, frames, boxes = stream_reqs[i]
            key = f'direct-{s}' if s else f'direct-once-{i}'
            direct.append(pred.predict(frames, boxes, stream=key,
                                       return_cameras=True))
            if s is None:
                pred.reset_camera_stream(key)
        for (s, i), resp, want_i in zip(seq, got, direct):
            _hold_response(f'serve stream {s}', resp, *want_i)
        a = [r['f0_camera'] for (s, _), r in zip(seq, got) if s == 'A']
        if not (np.array_equal(a[1], a[0]) and np.array_equal(a[2], a[0])
                and not np.array_equal(a[3], a[0])):
            raise RuntimeError('camcalib_every=3: stream A did not reuse '
                               'its keyframe camera on its 2nd and 3rd '
                               'frames')
        named = sorted(k for k in pred._cam_streams if k in ('A', 'B'))
        if named != ['A', 'B'] or any(k.startswith('\x00')
                                      for k in pred._cam_streams):
            raise RuntimeError(f'stream state {list(pred._cam_streams)}')
        print(f'[serve camcalib_every=3] {len(seq)} requests on streams A, '
              'B and header-less: responses match predict on the same '
              'streams; A reuses its keyframe camera on frames 2-3; '
              f'/stats {json.dumps(stats())}', flush=True)
        return launches
    finally:
        server.shutdown()
        thread.join(timeout=30)
        del pred
        _release()


class _EvalItems:
    """In-memory eval samples in the layout CamDataset yields (the card
    machine has no image codec): bench.py's eval inputs, with CamCalib's
    camera as the predicted one."""

    def __init__(self, n, seed):
        import numpy as np

        from spec_tpu_torch.bench import eval_inputs
        from spec_tpu_torch.core.geometry import euler_pitch_roll_np

        self.arrays = eval_inputs(n, EVAL_RES, seed=seed)
        # crops in [0, 1], as CamDataset yields them
        self.arrays['img'] = np.random.RandomState(seed).rand(
            n, EVAL_RES, EVAL_RES, 3).astype('f4')
        rng = np.random.RandomState(seed + 1)
        self.arrays['cam_int'] = self.arrays.pop('cam_intrinsics')
        self.arrays['pred_cam_rotmat'] = np.stack([
            euler_pitch_roll_np(p, r)
            for p, r in rng.randn(n, 2) * [0.2, 0.05]])
        self.arrays['pred_cam_int'] = self.arrays['cam_int'] * np.array(
            [1.1, 1.1, 1.0], 'f4')[:, None]
        self.arrays['pose_cam'] = (rng.randn(n, 72) * 0.15).astype('f4')

    def __len__(self):
        return len(self.arrays['img'])

    def __getitem__(self, i):
        item = {k: v[i] for k, v in self.arrays.items()}
        item['imgname'] = f'sample_{i:04d}.jpg'
        item['dataset_name'] = '3dpw-test-cam'
        return item


def _eval_pass(model, items, assets, jreg, device):
    """evaluate_dataset over ``items`` in batches of EVAL_BATCH, then
    compute_error on its vertices with the j14 and the j24 protocol.
    Returns (summary, headlines, K1 launches of each part, batches)."""
    import numpy as np

    from spec_tpu_torch.data.loader import DataLoader
    from spec_tpu_torch.eval.eval_loop import evaluate_dataset
    from spec_tpu_torch.eval.evaluator import compute_error
    from spec_tpu_torch.ops import lbs as L

    batches = []

    class Counted(DataLoader):
        def __iter__(self):
            for b in super().__iter__():
                batches.append(b['_valid_count'])
                yield b

    loader = Counted(items, batch_size=EVAL_BATCH, num_workers=4)
    L.LAUNCHES = 0
    summary, acc = evaluate_dataset(model, None, loader, assets, jreg,
                                    use_gt_cam=False, use_gender=True,
                                    dataset_name='3dpw-test-cam')
    launches = {'evaluate_dataset': L.LAUNCHES}
    res = acc.results_dict()
    heads = {}
    for ds in ('3dpw-test-cam', 'spec-mtp'):
        L.LAUNCHES = 0
        heads[ds] = compute_error(
            ds, pred_vertices=np.asarray(res['vertices'], np.float32),
            pred_cam_rotmat=items.arrays['pred_cam_rotmat'],
            gt_pose=items.arrays['pose'], gt_betas=items.arrays['betas'],
            assets=assets['neutral'], j_regressor_h36m=jreg,
            gt_pose_cam=items.arrays['pose_cam'], device=device)
        launches[f'compute_error {ds}'] = L.LAUNCHES
    return summary, heads, launches, batches, len(res['vertices'])


def phase_eval(device='cuda'):
    """Phase 13 (see the module docstring): the eval path at full width.
    Returns the eval step's K1 launches per replay. ``device='cpu'``
    rehearses the phase's logic on a machine without a card (shrink the
    EVAL_* sizes first): both sides of each comparison then run on the
    CPU, the kernel counts are 0 and the profile and the bench are
    skipped."""
    import torch
    from torch.utils._pytree import tree_leaves, tree_structure

    from spec_tpu_torch import bench
    from spec_tpu_torch.eval import eval_loop, evaluator
    from spec_tpu_torch.eval.eval_loop import (
        BATCH_KEYS,
        _procrustes_tail,
        make_eval_step,
    )
    from spec_tpu_torch.ops import lbs as L

    card = device == 'cuda'
    assets = bench.eval_assets()
    jreg = assets['neutral'].j_regressor_h36m.numpy()

    # 13.1 the step at the bench's inputs: replay vs eager, K1 per replay
    model = bench.eval_model(EVAL_BACKBONE, torch.bfloat16, device,
                             img_res=EVAL_RES)
    step = make_eval_step(model, assets, jreg, use_gender=True)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in bench.eval_inputs(EVAL_BATCH, EVAL_RES).items()}
    want = step.eager(batch)
    eager = tree_leaves(want)
    for call in ('capture', 'replay'):
        got = step(batch)
        same = (tree_structure(got) == tree_structure(want)
                and all(torch.equal(g, e)
                        for g, e in zip(tree_leaves(got), eager)))
        print(f'[eval step bf16 B={EVAL_BATCH}] {call} vs eager: '
              f'bit-identical {same} ({len(eager)} outputs)', flush=True)
        if not same:
            worst = max((g.float() - e.float()).abs().max().item()
                        for g, e in zip(tree_leaves(got), eager))
            raise RuntimeError(f'eval step replay differs from eager '
                               f'(max abs diff {worst:.3e})')
    L.LAUNCHES = 0
    step(batch)
    per_step = L.LAUNCHES
    print(f'[eval step bf16 B={EVAL_BATCH}] K1 launches per replay '
          f'{per_step} (expected {EVAL_K1_PER_STEP})')
    if card and per_step != EVAL_K1_PER_STEP:
        raise RuntimeError(f'the eval step launched K1 {per_step} times')
    print('[eval step] Procrustes runs outside the graph: the graph ends '
          'before it and the SVD alignments run eagerly after each replay '
          '(torch.linalg.svd on CUDA copies to the host, which a capture '
          'refuses)')
    if card:
        _graph_call(f'eval step bf16 B={EVAL_BATCH}', lambda: step(batch),
                    lbs=EVAL_K1_PER_STEP, k3=0)
        args = [batch[k] for k in BATCH_KEYS]
        with torch.inference_mode():
            head_ms = _wall_ms(lambda: step.head(*args), 5)
            head = step.head(*args)
            tail_ms = _wall_ms(lambda: _procrustes_tail(head), 5)
        print(f'[eval step bf16 B={EVAL_BATCH}] split: the graph replay (up '
              f'to Procrustes, outputs cloned) {head_ms:.3f} ms, the eager '
              f'Procrustes tail {tail_ms:.3f} ms (host wall with syncs, '
              'median of 5)', flush=True)
    del model, step, batch, got, want, eager
    if card:
        _release()

    # 13.2 card vs CPU, fp32, B = EVAL_CPU_BATCH
    items = _EvalItems(EVAL_SAMPLES, seed=3)
    small = {k: items.arrays[k][:EVAL_CPU_BATCH] for k in
             ('img', 'pose', 'betas', 'gender', 'scale', 'center',
              'orig_shape', 'cam_rotmat')}
    small['cam_intrinsics'] = items.arrays['cam_int'][:EVAL_CPU_BATCH]
    outs = {}
    models = {}
    for dev in (device, 'cpu'):
        models[dev] = bench.eval_model(EVAL_BACKBONE, torch.float32, dev,
                                       img_res=EVAL_RES)
        step = make_eval_step(models[dev], assets, jreg, use_gender=True)
        with torch.inference_mode():
            out, j14, j24, v2v = step({k: torch.from_numpy(small[k]).to(dev)
                                       for k in BATCH_KEYS})
        outs[dev] = (out['smpl_vertices'].cpu(),
                     {**{f'j14.{k}': v.cpu() for k, v in j14.items()},
                      **{f'j24.{k}': v.cpu() for k, v in j24.items()},
                      'v2v': v2v.cpu()})
    verts = (outs[device][0] - outs['cpu'][0]).abs().max().item()
    metrics = outs['cpu'][1]
    mm = max((outs[device][1][k] - metrics[k]).abs().max().item() * 1e3
             for k in metrics)
    print(f'[eval card vs cpu fp32 B={EVAL_CPU_BATCH}] vertices '
          f'{verts:.3e} m (limit {LBS_BUDGET:.0e}); metrics {mm:.3e} mm '
          f'(limit {EVAL_MM}) over {", ".join(metrics)}', flush=True)
    if not (verts <= LBS_BUDGET and mm <= EVAL_MM):
        raise RuntimeError('the eval step on the card disagrees with the '
                           'CPU')

    # 13.3 evaluate_dataset + compute_error, card vs CPU
    passes = {dev: _eval_pass(models[dev], items, assets, jreg, dev)
              for dev in (device, 'cpu')}
    summary, heads, launches, batches, n = passes[device]
    print(f'[eval evaluate_dataset] {EVAL_SAMPLES} samples in batches of '
          f'{EVAL_BATCH}: valid counts {batches}, {n} result rows; card '
          f'summary {json.dumps(summary)}; K1 launches {launches}',
          flush=True)
    tail = EVAL_SAMPLES - (len(batches) - 1) * EVAL_BATCH
    if batches != [EVAL_BATCH] * (len(batches) - 1) + [tail] \
            or tail == EVAL_BATCH or n != EVAL_SAMPLES:
        raise RuntimeError(f'evaluate_dataset batches {batches}, rows {n}')
    worst = max(abs(summary[k] - passes['cpu'][0][k]) for k in summary)
    for ds, head in heads.items():
        cpu_head = passes['cpu'][1][ds]
        worst = max(worst, *(abs(head[k] - cpu_head[k]) for k in head
                             if k != 'protocol'))
        print(f'[eval compute_error {ds}] card {json.dumps(head)}')
    print(f'[eval card vs cpu] summaries and headlines: worst '
          f'{worst:.3e} mm (limit {EVAL_MM})', flush=True)
    if not worst <= EVAL_MM:
        raise RuntimeError('evaluate_dataset / compute_error on the card '
                           'disagree with the CPU')
    # the memoized eval steps and chunk graphs hold both models, their
    # device assets and their graphs
    del models, passes
    eval_loop._EVAL_STEP_CACHE.clear()
    evaluator._CHUNK_CACHE.clear()
    if card:
        _release()

    # 13.4 the eval CLIs import and parse on this machine
    for cli in ('spec_eval', 'compute_error', 'annotate_camcalib'):
        proc = subprocess.run(
            [sys.executable, '-m', f'spec_tpu_torch.cli.{cli}', '--help'],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0 or 'usage' not in proc.stdout:
            raise RuntimeError(f'{cli} --help failed: {proc.stderr[-2000:]}')
        print(f'[eval cli] python -m spec_tpu_torch.cli.{cli} --help: ok')

    # 13.5 the bench's eval mode, once
    if card:
        print('[eval bench] python -m spec_tpu_torch.bench --mode eval',
              flush=True)
        if bench.main(['--mode', 'eval']) != 0:
            raise RuntimeError('the eval bench failed')
        _release()
    return per_step


def _model_rel(a: dict, b: dict) -> float:
    """L2 distance of two state_dicts over the L2 norm of ``b``."""
    num = den = 0.0
    for k, w in b.items():
        if k.endswith('num_batches_tracked'):
            continue
        d = a[k].detach().double().cpu() - w.detach().double().cpu()
        num += float((d * d).sum())
        den += float((w.detach().double() ** 2).sum())
    return (num / den) ** 0.5


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            state.optimizer.state_dict(), state.step)


def _restore(state, snap):
    sd, opt, step = snap
    state.model.load_state_dict(sd)
    state.optimizer.load_state_dict(opt)
    state.step = step


def _hold_losses(label, got, want, rtol):
    """Every loss term within ``rtol`` relative; a term under 1e-2 (the
    camera regularizer, ~1e-8) within ``rtol * 1e-2`` absolute."""
    worst = max(abs(float(got[k]) - float(want[k]))
                / max(abs(float(want[k])), 1e-2) for k in want)
    if set(got) != set(want) or not worst <= rtol:
        raise RuntimeError(f'{label}: losses differ by {worst:.3e} '
                           f'relative (limit {rtol:.0e})')
    return worst


class _TrainItems:
    """In-memory training samples in the layout CamDataset yields with
    ``is_train`` (the card machine has no image codec): bench.py's train
    inputs, crops in [0, 1]."""

    def __init__(self, n, res, seed):
        import numpy as np

        from spec_tpu_torch.bench import train_inputs

        self.arrays = train_inputs(n, res, seed=seed)
        self.arrays['img'] = np.random.RandomState(seed).rand(
            n, res, res, 3).astype('f4')
        self.arrays['cam_int'] = self.arrays.pop('cam_intrinsics')

    def __len__(self):
        return len(self.arrays['img'])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.arrays.items()}


def _train_cfg(logdir, backbone, batch, res):
    """The trainer's config without YAML (the card machine has none)."""
    from spec_tpu_torch.utils.config import spec_default_config

    cfg = spec_default_config()
    cfg.LOGDIR = str(logdir)
    cfg.LOG_FREQ_TB_IMAGES = 0
    cfg.SEED_VALUE = 0
    cfg.HMR.BACKBONE = backbone
    cfg.HMR.DTYPE = 'bfloat16'
    cfg.HMR.USE_CAM_FEATS = True
    cfg.DATASET.BATCH_SIZE = batch
    cfg.DATASET.NUM_WORKERS = 2
    cfg.DATASET.IMG_RES = res
    cfg.DATASET.VAL_DS = '3dpw-test-cam'
    cfg.TRAINING.LOG_SAVE_INTERVAL = 1
    cfg.TRAINING.MAX_EPOCHS = 2
    return cfg


def phase_train(device='cuda'):
    """The train phase (see the module docstring). Returns K1's launches
    over the TRAIN_STEPS graph replays. ``device='cpu'`` rehearses the
    phase's logic on a machine without a card (shrink the TRAIN_* sizes
    first): the "card" side then runs on the CPU too, the kernel counts
    are 0 and the profiles and the bench are skipped."""
    import shutil

    import numpy as np
    import torch

    from spec_tpu_torch import bench
    from spec_tpu_torch.cli import spec_eval
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.data.loader import DataLoader
    from spec_tpu_torch.eval import eval_loop, evaluator
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.train import (
        adam,
        create_train_state,
        make_spec_train_step,
    )
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils.precision import fp32_precision

    card = device == 'cuda'
    dev = torch.device(device)

    # 14.1 the full-width step: replay against eager from one state
    # (dropout off, cuDNN deterministic), then TRAIN_STEPS replays with
    # dropout from a generator registered with the graph
    state, step, batch = bench.train_setup(
        TRAIN_BATCH, TRAIN_BACKBONE, torch.bfloat16, dev, TRAIN_RES)
    head = state.model.head
    head.dropout_rate = 0.0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        step(state, batch)                       # eager first step, capture
        snap = _snapshot(state)
        _, eager = step.eager(state, batch)
        eager_sd = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}
        _restore(state, snap)
        _, replay = step(state, batch)
        rel = _model_rel(state.model.state_dict(), eager_sd)
        same = all(torch.equal(replay[k], eager[k]) for k in eager) and \
            rel == 0.0
        loss_rel = _hold_losses('train step replay vs eager', replay, eager,
                                TRAIN_REPLAY_LOSS_RTOL)
        print(f'[train step bf16 B={TRAIN_BATCH}] replay vs eager from one '
              f'state (cuDNN deterministic, dropout off): bit-identical '
              f'{same}; losses {loss_rel:.3e} relative (limit '
              f'{TRAIN_REPLAY_LOSS_RTOL:.0e}); the model after the step '
              f'{rel:.3e} relative (limit {TRAIN_REPLAY_MODEL_RTOL:.0e})',
              flush=True)
        if not rel <= TRAIN_REPLAY_MODEL_RTOL:
            raise RuntimeError('the train step replay differs from eager')
    finally:
        torch.backends.cudnn.deterministic = deterministic
    head.dropout_rate = 0.5
    gen = torch.Generator(device=dev).manual_seed(1)
    losses = [float(step(state, batch, gen)[1]['loss/total_loss'])]
    L.LAUNCHES = 0
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(step(state, batch, gen)[1]['loss/total_loss']))
    launches = L.LAUNCHES
    per_step = launches / (TRAIN_STEPS - 1)
    print(f'[train step bf16 B={TRAIN_BATCH}] {TRAIN_STEPS} steps with '
          f'dropout 0.5 from a generator: total loss '
          + ' '.join(f'{v:.3f}' for v in losses)
          + f'; K1 launches {launches} over {TRAIN_STEPS - 1} replays, '
          f'{per_step:g} per step (expected {TRAIN_K1_PER_STEP}); graphs '
          f'{len(step.graphs.signatures())}', flush=True)
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f'train loss not finite and falling: {losses}')
    if card and per_step != TRAIN_K1_PER_STEP:
        raise RuntimeError(f'the train step launched K1 {per_step} times')
    if card:
        wall = _wall_ms(lambda: step(state, batch, gen), 5)
        eager_wall = _wall_ms(lambda: step.eager(state, batch, gen), 5)
        print(f'[train step bf16 B={TRAIN_BATCH}] graph {wall:.3f} ms, '
              f'eager {eager_wall:.3f} ms per step (host wall with syncs, '
              f'median of 5); {TRAIN_BATCH / wall * 1e3:.1f} img/s',
              flush=True)
        _device_profile(f'train step bf16 B={TRAIN_BATCH}',
                        lambda: step(state, batch, gen), wall, 3, top=8)
    del state, step, batch
    if card:
        _release()

    # 14.2 card against CPU: TRAIN_CPU['steps'] fp32 steps at the golden's
    # size, dropout off, the same starting weights
    c = TRAIN_CPU
    assets = S.create_test_assets(num_vertices=c['vertices'])
    base = HMR(backbone=c['backbone'], use_cam_feats=True)
    base.reset_parameters(torch.Generator().manual_seed(0))
    runs = {}
    for where in (device, 'cpu'):
        model = HMR(backbone=c['backbone'], use_cam_feats=True)
        model.load_state_dict(base.state_dict())
        model.head.dropout_rate = 0.0
        model = model.to(where).train()
        st = create_train_state(model, adam(c['lr']))
        stp = make_spec_train_step(model, assets)
        b = {k: torch.from_numpy(v).to(where) for k, v in
             bench.train_inputs(c['batch'], c['res'], seed=2).items()}
        runs[where] = [(stp(st, b)[1], {k: v.detach().cpu().clone() for k, v
                                        in model.state_dict().items()})
                       for _ in range(c['steps'])]
    worst_loss = worst_model = 0.0
    for (gl, gsd), (wl, wsd) in zip(runs[device], runs['cpu']):
        worst_loss = max(worst_loss, _hold_losses(
            'train card vs cpu', gl, wl, TRAIN_LOSS_RTOL))
        worst_model = max(worst_model, _model_rel(gsd, wsd))
    print(f'[train card vs cpu fp32] {c["steps"]} steps at B={c["batch"]} '
          f'{c["res"]}^2 V={c["vertices"]} {c["backbone"]}: losses '
          f'{worst_loss:.3e} relative (limit {TRAIN_LOSS_RTOL:.0e}), the '
          f'model {worst_model:.3e} relative (limit '
          f'{TRAIN_MODEL_RTOL:.0e}); total loss card '
          + ' '.join(f'{float(l["loss/total_loss"]):.4f}'
                     for l, _ in runs[device]), flush=True)
    if not worst_model <= TRAIN_MODEL_RTOL:
        raise RuntimeError('the train steps on the card disagree with the '
                           'CPU')
    del runs

    # 14.3 K1's gradient inside the step: every parameter's gradient with
    # the kernel (and its closed-form backward) against autograd through
    # the plain version, fp32, V = 6890
    full = S.create_test_assets()
    model = HMR(backbone=c['backbone'], use_cam_feats=True)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model = model.to(dev).train()
    st = create_train_state(model, adam(1e-4))
    stp = make_spec_train_step(model, full)
    b = {k: torch.from_numpy(v).to(dev) for k, v in
         bench.train_inputs(TRAIN_GRAD_BATCH, 224, seed=4).items()}
    grads = {}
    kernel = L.fused_lbs_vertices
    for label in ('kernel', 'plain'):
        if label == 'plain':
            L.fused_lbs_vertices = L.fused_lbs_vertices_plain
        before = L.LAUNCHES
        try:
            g = torch.Generator(device=dev).manual_seed(5)
            with fp32_precision():
                total, _ = stp.loss_fn(model, g, b)
                grads[label] = torch.autograd.grad(total,
                                                   st.optimizer.params)
        finally:
            L.fused_lbs_vertices = kernel
        print(f'[train K1 gradient] {label}: K1 launches '
              f'{L.LAUNCHES - before}')
    worst = max(((a - p).abs().max() / p.abs().max().clamp_min(1e-30))
                .item() for a, p in zip(grads['kernel'], grads['plain']))
    print(f'[train K1 gradient] fp32 B={TRAIN_GRAD_BATCH} V=6890: every '
          f'parameter gradient through the kernel within {worst:.3e} of its '
          f'largest entry of autograd through the plain version (budget '
          f'{LBS_GRAD_BUDGET:.0e}), {len(grads["plain"])} tensors',
          flush=True)
    if not worst <= LBS_GRAD_BUDGET:
        raise RuntimeError('K1 gradient inside the train step disagrees')
    del model, st, stp, grads

    # K1's own work per train step at TRAIN_BATCH: two forwards, one
    # closed-form backward
    if card:
        packed = L.pack_lbs_operands(full.to(dev)).to(dev)
        coeffs, rel_tf = _lbs_operands(packed, full.to(dev), TRAIN_BATCH,
                                       seed=7)
        gout = torch.randn(TRAIN_BATCH, 6890, 3, device=dev)
        from spec_tpu_torch.bench import device_profile
        with torch.no_grad():
            fwd = device_profile(lambda: L.fused_lbs_vertices(
                packed, coeffs, rel_tf), 20)
            # the step differentiates coeffs and rel_tf only
            bwd = device_profile(lambda: L.fused_lbs_backward(
                packed.dirs, packed.weights_t, coeffs, rel_tf, 6890, gout,
                needs=(False, False, True, True)), 20)
        fwd_ms = sum(v for n, v in fwd['by_name'].items()
                     if 'lbs_kernel' in n)
        print(f'[train K1 B={TRAIN_BATCH}] forward kernel {fwd_ms:.4f} ms '
              f'(profiler, mean of 20); closed-form backward '
              f'{bwd["busy_ms"]:.4f} ms device busy in '
              f'{bwd["device_ops"]:.0f} device ops (mean of 20); per train '
              f'step (2 forwards + 1 backward) '
              f'{2 * fwd_ms + bwd["busy_ms"]:.4f} ms', flush=True)
        del packed, coeffs, rel_tf, gout
        _release()

    # 14.4 SpecTrainer: fit, checkpoint, resume, spec_eval's loader
    work = ROOT / 'build' / 'spec_tpu_torch' / 'train_smoke'
    shutil.rmtree(work, ignore_errors=True)
    items = _TrainItems(TRAINER_SAMPLES, TRAIN_RES, seed=8)
    val_items = _EvalItems(TRAINER_BATCH * 2, seed=9)
    jreg = full.j_regressor_h36m.numpy()

    def trainer(run):
        cfg = _train_cfg(work / run, TRAINER_BACKBONE, TRAINER_BATCH,
                         TRAIN_RES)
        model = HMR(backbone=TRAINER_BACKBONE, use_cam_feats=True,
                    dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return SpecTrainer(
            cfg, model.to(dev).train(), {'neutral': full}, jreg,
            lambda epoch: items,
            lambda: {'3dpw-test-cam': DataLoader(
                val_items, batch_size=TRAINER_BATCH, num_workers=2)})

    first = trainer('run0')
    L.LAUNCHES = 0
    first.fit(max_epochs=1)
    per_epoch = TRAINER_SAMPLES // TRAINER_BATCH
    steps = sorted(os.listdir(first.ckpt_dir))
    print(f'[trainer] fit 1 epoch: step {first.state.step}, K1 launches '
          f'{L.LAUNCHES} (training and validation), checkpoints {steps}',
          flush=True)
    if first.state.step != per_epoch or f'step_{per_epoch:08d}' not in steps:
        raise RuntimeError(f'trainer: step {first.state.step}, {steps}')
    second = trainer('run1')
    second.resume()
    if (second.state.step, second._resume_epoch) != (per_epoch, 1):
        raise RuntimeError('trainer resume: step '
                           f'{second.state.step}, epoch '
                           f'{second._resume_epoch}')
    second.fit(max_epochs=2)
    with open(os.path.join(second.ckpt_dir, 'meta.json')) as f:
        meta = json.load(f)
    print(f'[trainer] resumed from step {per_epoch} in a sibling run, fit '
          f'to step {second.state.step}; meta {json.dumps(meta)}',
          flush=True)
    if second.state.step != 2 * per_epoch:
        raise RuntimeError(f'trainer after resume: step {second.state.step}')
    model = spec_eval.build_model(second.cfg, second.ckpt_dir, dev)
    same = all(torch.equal(v, second.model.state_dict()[k].to(v.device))
               for k, v in model.state_dict().items())
    print(f"[trainer] spec_eval's loader read {second.ckpt_dir}: weights "
          f'equal to the trainer\'s {same}', flush=True)
    if not same:
        raise RuntimeError('spec_eval loaded other weights than trained')
    del first, second, model
    eval_loop._EVAL_STEP_CACHE.clear()
    evaluator._CHUNK_CACHE.clear()
    shutil.rmtree(work, ignore_errors=True)

    # 14.5 the CLI imports and parses here; the bench's train mode,
    # graph and eager
    proc = subprocess.run(
        [sys.executable, '-m', 'spec_tpu_torch.cli.spec_train', '--help'],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or 'usage' not in proc.stdout:
        raise RuntimeError(f'spec_train --help failed: {proc.stderr[-2000:]}')
    print('[train cli] python -m spec_tpu_torch.cli.spec_train --help: ok')
    if card:
        _release()
        for extra in ([], ['--eager']):
            print('[train bench] python -m spec_tpu_torch.bench --mode '
                  'train --profile ' + ' '.join(extra), flush=True)
            if bench.main(['--mode', 'train', '--profile'] + extra) != 0:
                raise RuntimeError('the train bench failed')
            _release()
    return launches


# -- this slice: CamCalib training, SMPLify, REMAT ----------------------

# The released CamCalib recipe, configs/camcalib/config_sa_bias_l2.yaml,
# as a dict (the card machine has no YAML reader;
# tests/test_torch_camcalib_train.py holds the two equal): ResNet-50, one
# 1024-wide FC layer per head, softargmax biased-L2 at weights 10, Adam
# 1e-3, fp32, batches of 4.
CAMCALIB_RECIPE = {
    'EXP_NAME': 'pano_scalenet_softargmax_biased_l2_lw10',
    'METHOD': 'pano',
    'DATASET': {'TRAIN_DS': 'pano_scalenet', 'VAL_DS': 'pano_scalenet',
                'BATCH_SIZE': 4, 'NUM_WORKERS': 16, 'IMG_RES': 224},
    'OPTIMIZER': {'TYPE': 'adam', 'LR': 0.001, 'WD': 0.0},
    'TRAINING': {'MAX_EPOCHS': 30, 'SAVE_IMAGES': True,
                 'LOG_SAVE_INTERVAL': 50, 'LOG_FREQ_TB_IMAGES': 2000},
    'MODEL': {'BACKBONE': 'resnet50', 'NUM_FC_LAYERS': 1,
              'NUM_FC_CHANNELS': 1024, 'LOSS_TYPE': 'softargmax_biased_l2',
              'LOSS_VFOV_WEIGHT': 10.0, 'LOSS_PITCH_WEIGHT': 10.0,
              'LOSS_ROLL_WEIGHT': 10.0},
}
# Full-resolution frames of the in-memory pano items and their buckets at
# MIN_RES 600 / MAX_RES 1000 (multiples of 64): 480x640 resizes to
# 600x800, 720x1280 to 562x1000 (562.5 rounds to even).
CAMCALIB_FRAMES = {(480, 640): (640, 832), (720, 1280): (576, 1024)}
CAMCALIB_MIN_MAX = (600, 1000)
CAMCALIB_TIMING_BATCH = 16
# Card against CPU: three fp32 steps at phase 8's small size, Adam 1e-5
# (Adam's sign noise grows the card/CPU gap a few times per step at
# 1e-3); phase 14's limits.
CAMCALIB_CPU = dict(batch=4, hw=(64, 96), backbone='resnet18', steps=3,
                    lr=1e-5)
# SMPLify at the train batch: B = 64, the default 100 iterations,
# synthetic SMPL (V = 6890), targets projected from a perturbed pose (the
# reference test's problem). Card against CPU at B = 8 and 10
# iterations: each fitted parameter within 1e-4 absolute (read on the
# CPU against the JAX package at 100 iterations: 5e-7), the per-sample
# reprojection loss within 1e-4 relative, the acceptance at the median
# per-joint loss equal.
SMPLIFY_BATCH, SMPLIFY_ITERS = 64, 100
SMPLIFY_CPU = dict(batch=8, iters=10)
SMPLIFY_PARAM_ATOL, SMPLIFY_REPROJ_RTOL = 1e-4, 1e-4


def _k1_backward_work(B, V=6890, C=218):
    """FLOPs and bytes of ``ops/lbs.fused_lbs_backward`` for the
    ``coeffs`` and ``rel_tf`` cotangents over V vertices: the recompute
    of ``posed`` (2 B C 3 V) and of the blended transforms (2 B 12 24 V),
    ``dposed`` (2 B 9 V), ``dcoeffs`` (2 B 3 V C), ``dt`` (B 9 V) and
    ``da`` (2 B 12 V 24); each input read once (dirs, weights_t over V
    vertices, coeffs, rel_tf, the (B, V, 3) cotangent), each output
    written once (dcoeffs, da)."""
    flops = 2.0 * B * V * (3 * C + 12 * 24 + 9 + 3 * C + 12 * 24) \
        + 9.0 * B * V
    nbytes = 4.0 * (3 * C * V + 24 * V + 2 * B * C + 2 * B * 24 * 12
                    + B * V * 3)
    return flops, nbytes


class _StopAfter:
    """A GracefulShutdown whose flag rises at check ``n + 1``: a preempted
    run, without a signal."""

    def __init__(self, n):
        self.n, self.checks = n, 0

    @property
    def requested(self):
        self.checks += 1
        return self.checks > self.n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _PanoItems:
    """In-memory CamCalib items as ``CameraRegressorDataset`` yields them
    (the card machine decodes no JPEG): uint8 frames already resized from
    the full-resolution sizes of CAMCALIB_FRAMES, in turns, with
    ``shape_buckets`` from those sizes; DEVICE_JITTER items carry the
    jitter affine, the others are jittered (train) or normalized (val)
    on the host."""

    def __init__(self, n, seed, device_jitter, is_train, frames=None):
        import numpy as np

        from spec_tpu_torch.data import pano_dataset as TP

        rng = np.random.RandomState(seed)
        frames = frames or list(CAMCALIB_FRAMES)
        min_max = CAMCALIB_MIN_MAX
        self.items, self.buckets = [], {}
        for i in range(n):
            h, w = frames[i % len(frames)]
            s = TP.resize_scale(w, h, *min_max)
            arr = rng.randint(0, 256, (round(h * s), round(w * s), 3)
                              ).astype(np.uint8)
            self.items.append(TP.make_item(
                arr, np.array((w, h), np.int32), 0.6 + 0.02 * i,
                0.01 * i - 0.1, 0.05 - 0.01 * i, f'frame{i}',
                'softargmax_biased_l2', is_train, device_jitter, rng))
            self.buckets.setdefault(TP.resized_bucket(w, h, *min_max),
                                    []).append(i)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def shape_buckets(self):
        return self.buckets


def _pano_batch(n, hw, device_jitter, seed, device):
    """One bucketed batch of ``n`` frames of full-resolution ``hw`` on
    ``device``, in the train step's layout."""
    import torch

    from spec_tpu_torch.cli.camcalib_train import _TRAIN_KEYS
    from spec_tpu_torch.data.pano_dataset import pad_collate

    items = _PanoItems(n, seed, device_jitter, True, frames=[hw])
    (bucket,) = items.shape_buckets()
    batch = pad_collate(items.items, fixed_hw=bucket)
    return {k: torch.from_numpy(batch[k]).to(device) for k in _TRAIN_KEYS
            if k in batch}


def _camcalib_cfg(logdir):
    from spec_tpu_torch.utils.config import camcalib_default_config

    cfg = camcalib_default_config()
    cfg.merge_from_dict(CAMCALIB_RECIPE)
    cfg.DATASET.MIN_RES, cfg.DATASET.MAX_RES = CAMCALIB_MIN_MAX
    cfg.LOGDIR = str(logdir)
    cfg.SEED_VALUE = 0
    return cfg


def _same_state(label, state, want_sd, got, want):
    """Bit for bit: the metrics and the whole state_dict."""
    import torch

    same = set(got) == set(want) and all(
        torch.equal(got[k], want[k]) for k in want) and all(
        torch.equal(v, want_sd[k])
        for k, v in state.model.state_dict().items())
    print(f'[{label}] replay vs eager from one state (cuDNN deterministic): '
          f'bit-identical {same}', flush=True)
    if not same:
        raise RuntimeError(f'{label}: the replay differs from the eager body')


def phase_camcalib_train(device='cuda'):
    """CamCalib training at the released recipe (see the module
    docstring). ``device='cpu'`` rehearses the logic on a machine
    without a card (shrink CAMCALIB_FRAMES, the recipe's backbone and
    CAMCALIB_TIMING_BATCH first)."""
    import io
    import shutil

    import numpy as np
    import torch

    from spec_tpu_torch.cli import camcalib_train as TC
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.train import (
        adam,
        create_train_state,
        make_camcalib_train_step,
        make_optimizer,
    )
    from spec_tpu_torch.utils import preemption
    from spec_tpu_torch.utils.config import resolve_camcalib_loss

    card = device == 'cuda'
    dev = torch.device(device)
    work = ROOT / 'build' / 'spec_tpu_torch' / 'camcalib_smoke'
    shutil.rmtree(work, ignore_errors=True)
    cfg = _camcalib_cfg(work / 'run0')
    loss_kw = dict(loss_type=resolve_camcalib_loss(cfg),
                   vfov_loss_weight=cfg.MODEL.LOSS_VFOV_WEIGHT,
                   pitch_loss_weight=cfg.MODEL.LOSS_PITCH_WEIGHT,
                   roll_loss_weight=cfg.MODEL.LOSS_ROLL_WEIGHT)
    B = cfg.DATASET.BATCH_SIZE
    hw0 = next(iter(CAMCALIB_FRAMES))
    label = (f'camcalib step {cfg.MODEL.BACKBONE} fp32 B={B} '
             f'bucket {CAMCALIB_FRAMES[hw0]}')

    # 15.1 a replay against the eager body from one state, fp32 batches
    # and DEVICE_JITTER uint8 batches with their affines
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = TC.build_model(cfg, dev)
        state = create_train_state(model, make_optimizer(cfg.OPTIMIZER))
        step = make_camcalib_train_step(model, **loss_kw)
        for jitter in (False, True):
            batch = _pano_batch(B, hw0, jitter, seed=1, device=dev)
            step(state, batch)                  # eager first step, capture
            snap = _snapshot(state)
            _, eager = step.eager(state, batch)
            eager_sd = {k: v.detach().clone()
                        for k, v in state.model.state_dict().items()}
            _restore(state, snap)
            _, replay = step(state, batch)
            _same_state(f'{label}{" u8 jitter" if jitter else ""}', state,
                        eager_sd, replay, eager)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f'[{label}] graphs {len(step.graphs.signatures())}: '
          + '; '.join(str(s[0][0]) + ' ' + str(s[0][1]).replace('torch.', '')
                      for s in step.graphs.signatures()), flush=True)
    del model, state, step, batch
    if card:
        _release()

    # 15.2 the epoch loop over in-memory datasets: two buckets, two steps
    # an epoch; a run preempted after its first step, and a resume in a
    # sibling run that skips that batch and trains on to epoch 2
    train_ds = _PanoItems(2 * B, 2, True, True)
    val_ds = _PanoItems(B, 3, False, False)
    cfg.TRAINING.LOG_SAVE_INTERVAL = 1
    cfg.TRAINING.MAX_EPOCHS = 1
    cfg.DATASET.NUM_WORKERS = 2
    logs = {}
    shutdown = preemption.GracefulShutdown
    try:
        for run, stop_after, epochs, resume in (('run0', 1, 1, False),
                                                ('run1', 10 ** 6, 2, True)):
            cfg.LOGDIR = str(work / run)
            cfg.TRAINING.MAX_EPOCHS = epochs
            os.makedirs(cfg.LOGDIR, exist_ok=True)
            preemption.GracefulShutdown = lambda n=stop_after: _StopAfter(n)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                st = TC.train(cfg, train_ds, val_ds, dev, resume=resume)
            logs[run] = (buf.getvalue(), st.step)
            for line in buf.getvalue().splitlines():
                if line.startswith('[camcalib'):
                    print(f'[camcalib fit {run}] {line}', flush=True)
            del st
    finally:
        preemption.GracefulShutdown = shutdown
    text0, step0 = logs['run0']
    text1, step1 = logs['run1']
    want_skip = 'skipping 0 completed epoch(s) + 1 batch(es) (2 steps/epoch)'
    ok = (step0 == 1 and 'preempted at step 1' in text0 and step1 == 4
          and want_skip in text1 and text1.count('MAE(deg)') == 2
          and 'nan' not in text1.lower())
    print(f'[camcalib fit] preempted at step {step0}, resumed in a sibling '
          f'run to step {step1} (skip line present: {want_skip in text1}); '
          f'ok {ok}', flush=True)
    if not ok:
        raise RuntimeError('the CamCalib fit loop, checkpoint or resume '
                           'failed')
    shutil.rmtree(work, ignore_errors=True)
    if card:
        _release()

    # 15.3 card against CPU: CAMCALIB_CPU['steps'] fp32 steps, one init
    c = CAMCALIB_CPU
    base = CameraRegressorNetwork(backbone=c['backbone'], num_fc_layers=1)
    base.reset_parameters(torch.Generator().manual_seed(4))
    rng = np.random.RandomState(5)
    arrays = {'img': rng.randn(c['batch'], *c['hw'], 3).astype('f4'),
              'vfov': rng.uniform(-1, 1, c['batch']).astype('f4'),
              'pitch': rng.uniform(-1, 1, c['batch']).astype('f4'),
              'roll': rng.uniform(-1, 1, c['batch']).astype('f4')}
    runs = {}
    for where in (device, 'cpu'):
        m = CameraRegressorNetwork(backbone=c['backbone'], num_fc_layers=1)
        m.load_state_dict(base.state_dict())
        m = m.to(where).train()
        st = create_train_state(m, adam(c['lr']))
        stp = make_camcalib_train_step(m, **loss_kw)
        b = {k: torch.from_numpy(v).to(where) for k, v in arrays.items()}
        runs[where] = [(stp(st, b)[1], {k: v.detach().cpu().clone()
                                        for k, v in m.state_dict().items()})
                       for _ in range(c['steps'])]
    worst_loss = worst_model = 0.0
    for (gl, gsd), (wl, wsd) in zip(runs[device], runs['cpu']):
        worst_loss = max(worst_loss, _hold_losses(
            'camcalib card vs cpu', gl, wl, TRAIN_LOSS_RTOL))
        worst_model = max(worst_model, _model_rel(gsd, wsd))
    print(f'[camcalib card vs cpu fp32] {c["steps"]} steps at '
          f'B={c["batch"]} {c["hw"][0]}x{c["hw"][1]} {c["backbone"]}: '
          f'losses {worst_loss:.3e} relative (limit {TRAIN_LOSS_RTOL:.0e}), '
          f'the model {worst_model:.3e} relative (limit '
          f'{TRAIN_MODEL_RTOL:.0e})', flush=True)
    if not worst_model <= TRAIN_MODEL_RTOL:
        raise RuntimeError('CamCalib steps on the card disagree with the '
                           'CPU')
    del runs

    # 15.4 ms per step at CAMCALIB_TIMING_BATCH in the first bucket
    out = {}
    if card:
        _release()
        torch.cuda.reset_peak_memory_stats()
        cfg.LOGDIR = str(work)
        model = TC.build_model(cfg, dev)
        state = create_train_state(model, make_optimizer(cfg.OPTIMIZER))
        step = make_camcalib_train_step(model, **loss_kw)
        bt = CAMCALIB_TIMING_BATCH
        for jitter in (False, True):
            batch = _pano_batch(bt, hw0, jitter, seed=6, device=dev)
            tag = 'u8 jitter' if jitter else 'fp32'
            wall = _wall_ms(lambda: step(state, batch), 5)
            eager_wall = _wall_ms(lambda: step.eager(state, batch), 3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f'[camcalib step {tag} B={bt} bucket {CAMCALIB_FRAMES[hw0]}]'
                  f' graph {wall:.3f} ms, eager {eager_wall:.3f} ms per step '
                  f'(median of 5 and 3); {bt / wall * 1e3:.1f} img/s; peak '
                  f'memory {peak:.2f} GiB (max_memory_allocated since the '
                  'model was built)', flush=True)
            prof = _device_profile(f'camcalib step {tag} B={bt}',
                                   lambda: step(state, batch), wall, 2,
                                   top=6)
            out[tag] = dict(ms=wall, eager_ms=eager_wall, peak_gib=peak,
                            busy_ms=prof['busy_ms'])
        del model, state, step, batch
        _release()

    # 15.5 the CLI imports and parses here
    proc = subprocess.run(
        [sys.executable, '-m', 'spec_tpu_torch.cli.camcalib_train', '--help'],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or 'usage' not in proc.stdout:
        raise RuntimeError('camcalib_train --help failed: '
                           f'{proc.stderr[-2000:]}')
    print('[camcalib cli] python -m spec_tpu_torch.cli.camcalib_train '
          '--help: ok', flush=True)
    return out


def _smplify_problem(B, assets, seed):
    """The reference test's fitting problem (``tests/test_smplify.py``):
    49 keypoints projected from a GT pose (camera at 5 m, f = 1000 px),
    the fit started from a perturbed one. numpy arrays, in
    ``smplify_fit``'s order."""
    import numpy as np
    import torch

    from spec_tpu_torch.core import smpl as S

    rng = np.random.RandomState(seed)
    gt_go = rng.randn(B, 1, 3).astype('f4') * 0.2
    gt_bp = rng.randn(B, 23, 3).astype('f4') * 0.2
    gt_betas = rng.randn(B, 10).astype('f4') * 0.5
    gt_t = np.tile(np.array([[0.0, 0.0, 5.0]], 'f4'), (B, 1))
    R = np.tile(np.eye(3, dtype='f4'), (B, 1, 1))
    K = np.tile(np.array([[1000.0, 0, 500], [0, 1000.0, 500], [0, 0, 1]],
                         'f4'), (B, 1, 1))
    with torch.no_grad():
        joints = S.smpl_forward(
            assets, torch.from_numpy(gt_betas), torch.from_numpy(gt_bp),
            torch.from_numpy(gt_go), pose2rot=True,
            joint_set='spin49').joints.numpy()
    pts = joints + gt_t[:, None]
    proj = pts @ K[0].T
    kp = np.concatenate([proj[..., :2] / proj[..., 2:3],
                         np.ones((B, 49, 1), 'f4')], -1).astype('f4')
    return [gt_go + rng.randn(*gt_go.shape).astype('f4') * 0.1,
            gt_bp + rng.randn(*gt_bp.shape).astype('f4') * 0.15,
            np.zeros((B, 10), 'f4'),
            gt_t + rng.randn(B, 3).astype('f4') * 0.2, kp, R, K]


def phase_smplify(device='cuda'):
    """In-loop SMPLify (see the module docstring). Returns K1's launches
    per fit replay and the fit's numbers. ``device='cpu'`` rehearses the
    logic (shrink SMPLIFY_BATCH, SMPLIFY_ITERS and the trainer sizes)."""
    import shutil

    import numpy as np
    import torch

    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.train import smplify as TF
    from spec_tpu_torch.train.trainer import SpecTrainer

    card = device == 'cuda'
    dev = torch.device(device)
    full = S.create_test_assets()
    assets = S.fused_on(full, dev)
    B, n_it = SMPLIFY_BATCH, SMPLIFY_ITERS
    label = f'smplify B={B} iters={n_it} V={full.num_vertices}'
    args = [torch.from_numpy(a).to(dev)
            for a in _smplify_problem(B, full, seed=11)]

    # 16.1 a replay against the eager body, bit for bit
    TF.smplify_fit(assets, *args, num_iters=n_it)     # eager run, capture
    eager = TF.smplify_fit(assets, *args, num_iters=n_it, eager=True)
    before = L.LAUNCHES
    replay = TF.smplify_fit(assets, *args, num_iters=n_it)
    launches = L.LAUNCHES - before
    same = all(torch.equal(a, b) for a, b in zip(replay, eager))
    print(f'[{label}] replay vs eager: bit-identical {same}', flush=True)
    if not same:
        raise RuntimeError('the SMPLify replay differs from its eager body')

    # 16.2 the reprojection loss falls from the start
    start = TF.smplify_fit(assets, *args, num_iters=0, eager=True)
    r0 = start.reproj_loss.cpu().numpy()
    r1 = replay.reproj_loss.cpu().numpy()
    fell = int((r1 < r0).sum())
    print(f'[{label}] reprojection loss (px^2, conf-weighted GMoF summed '
          f'over joints): median {np.median(r0):.1f} -> {np.median(r1):.1f};'
          f' fell for {fell} of {B} samples; finite '
          f'{bool(np.isfinite(r1).all())}', flush=True)
    if not (np.isfinite(r1).all() and r1.sum() < r0.sum()
            and fell >= 0.9 * B):
        raise RuntimeError('the SMPLify fit did not bring the loss down')

    # 16.3 ms per fit and the replay's device profile: K1 launches per
    # replay (the wrapper's count above and the profiler's), the top
    # device operations, K1's forward time and its backward's estimate
    out = {'launches': launches}
    if card:
        fit = lambda: TF.smplify_fit(assets, *args, num_iters=n_it)  # noqa
        wall = _wall_ms(fit, 5)
        prof = _device_profile(label, fit, wall, 2, top=10)
        print(f'[{label}] K1 launches per replay: wrapper {launches}, '
              f'profiler {prof["lbs_kernel"]:g} (expected {n_it + 1})',
              flush=True)
        if not launches == prof['lbs_kernel'] == n_it + 1:
            raise RuntimeError('the SMPLify fit did not launch K1 once per '
                               'forward')
        k1_fwd = sum(ms for name, ms in prof['by_name'].items()
                     if 'lbs_kernel' in name)
        packed = assets.packed_lbs
        coeffs, rel_tf = _lbs_operands(packed, assets, B, seed=13)
        gout = torch.randn(B, full.num_vertices, 3, device=dev)
        from spec_tpu_torch.bench import device_profile
        with torch.no_grad():
            bwd = device_profile(lambda: L.fused_lbs_backward(
                packed.dirs, packed.weights_t, coeffs, rel_tf,
                full.num_vertices, gout, needs=(False, False, True, True)),
                20)
        k1_bwd = n_it * bwd['busy_ms']
        flops, nbytes = _k1_backward_work(B, full.num_vertices)
        bwd_bound, bwd_by = _bound(flops, nbytes, PEAK_FLOPS['fp32'])
        busy = prof['busy_ms']
        print(f'[{label}] {wall:.3f} ms per fit (host wall with syncs, '
              f'median of 5), device busy {busy:.3f} ms; K1 forward '
              f'{k1_fwd:.3f} ms per fit ({k1_fwd / busy:.1%} of busy, '
              f'{n_it + 1} launches); K1 backward {bwd["busy_ms"]:.4f} ms '
              f'alone at B={B} (mean of 20, {bwd["device_ops"]:.0f} device '
              f'ops), x{n_it} = {k1_bwd:.3f} ms ({k1_bwd / busy:.1%} of '
              f'busy, an estimate from the backward run alone); backward '
              f'bound {bwd_bound:.4f} ms ({bwd_by}: {flops / 1e9:.3f} GFLOP,'
              f' {nbytes / 1e6:.1f} MB), share '
              f'{bwd_bound / bwd["busy_ms"]:.3f}', flush=True)
        out.update(ms=wall, busy_ms=busy, k1_fwd_ms=k1_fwd,
                   k1_bwd_ms=bwd['busy_ms'], k1_bwd_bound_ms=bwd_bound)
        del packed, coeffs, rel_tf, gout
        _release()

    # 16.4 card against CPU at SMPLIFY_CPU's size
    c = SMPLIFY_CPU
    small = _smplify_problem(c['batch'], full, seed=12)
    fits = {}
    for where in (device, 'cpu'):
        a = S.fused_on(full, where)
        fits[where] = TF.smplify_fit(
            a, *[torch.from_numpy(x).to(where) for x in small],
            num_iters=c['iters'])
    got, want = fits[device], fits['cpu']
    p_err = max(float((g.cpu() - w).abs().max()) for g, w in
                zip(got[:4], want[:4]))
    r_err = float(((got.reproj_loss.cpu() - want.reproj_loss).abs()
                   / want.reproj_loss.abs()).max())
    thr = float(np.median(want.reproj_loss.numpy() / 49.0))
    batch = {'pose': np.zeros((c['batch'], 72), 'f4'),
             'betas': np.zeros((c['batch'], 10), 'f4'),
             'has_smpl': np.zeros(c['batch'], 'f4'),
             'keypoints_orig': small[4]}
    same_mask = np.array_equal(
        TF.apply_smplify_update(batch, got, thr)['has_smpl'],
        TF.apply_smplify_update(batch, want, thr)['has_smpl'])
    print(f'[smplify card vs cpu] B={c["batch"]} iters={c["iters"]}: '
          f'parameters {p_err:.3e} absolute (limit '
          f'{SMPLIFY_PARAM_ATOL:.0e}), reprojection loss {r_err:.3e} '
          f'relative (limit {SMPLIFY_REPROJ_RTOL:.0e}), acceptance equal '
          f'{same_mask}', flush=True)
    if not (p_err <= SMPLIFY_PARAM_ATOL and r_err <= SMPLIFY_REPROJ_RTOL
            and same_mask):
        raise RuntimeError('SMPLify on the card disagrees with the CPU')
    del fits

    # 16.5 SpecTrainer with RUN_SMPLIFY over in-memory samples
    work = ROOT / 'build' / 'spec_tpu_torch' / 'smplify_smoke'
    shutil.rmtree(work, ignore_errors=True)
    items = _TrainItems(TRAINER_SAMPLES, TRAIN_RES, seed=14)
    items.arrays['has_smpl'][::2] = 0.0          # half have no GT SMPL
    cfg = _train_cfg(work / 'run0', TRAINER_BACKBONE, TRAINER_BATCH,
                     TRAIN_RES)
    cfg.TRAINING.RUN_SMPLIFY = True
    model = HMR(backbone=TRAINER_BACKBONE, use_cam_feats=True,
                dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = SpecTrainer(cfg, model.to(dev).train(), {'neutral': full},
                          full.j_regressor_h36m.numpy(), lambda e: items,
                          lambda: {})
    counts = {'fits': 0, 'samples': 0, 'accepted': 0}
    hook = trainer._run_smplify

    def counted(dev_batch):
        res = hook(dev_batch)
        counts['fits'] += 1
        counts['samples'] += len(res['has_smpl'])
        counts['accepted'] += int((res['has_smpl']
                                   - dev_batch['has_smpl']).sum())
        return res

    trainer._run_smplify = counted
    trainer.fit(max_epochs=1)
    per_epoch = TRAINER_SAMPLES // TRAINER_BATCH
    print(f'[trainer RUN_SMPLIFY] {counts["fits"]} fits of '
          f'{cfg.TRAINING.NUM_SMPLIFY_ITERS} iterations over '
          f'{counts["samples"]} samples (half without GT SMPL), '
          f'{counts["accepted"]} fits accepted at SMPLIFY_THRESHOLD '
          f'{cfg.TRAINING.SMPLIFY_THRESHOLD}; step {trainer.state.step}',
          flush=True)
    if counts['fits'] != per_epoch or trainer.state.step != per_epoch:
        raise RuntimeError('the trainer did not fit before every step')
    del trainer, model
    shutil.rmtree(work, ignore_errors=True)
    if card:
        _release()
    return out


def phase_remat(device='cuda'):
    """TRAINING.REMAT at the bench's train setup (see the module
    docstring). ``device='cpu'`` rehearses the logic (shrink TRAIN_*)."""
    import torch

    from spec_tpu_torch import bench

    card = device == 'cuda'
    dev = torch.device(device)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            if card:
                _release()
                torch.cuda.reset_peak_memory_stats()
            state, step, batch = bench.train_setup(
                TRAIN_BATCH, TRAIN_BACKBONE, torch.bfloat16, dev, TRAIN_RES,
                remat=remat)
            state.model.head.dropout_rate = 0.0
            step(state, batch)                # eager first step, capture
            _, losses = step(state, batch)    # one replay
            sd = {k: v.detach().cpu().clone()
                  for k, v in state.model.state_dict().items()}
            wall = peak = None
            if card:
                wall = _wall_ms(lambda: step(state, batch), 5)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
            runs[remat] = (losses, sd, wall, peak)
            del state, step, batch
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l0, sd0, w0, p0), (l1, sd1, w1, p1) = runs[False], runs[True]
    same = all(torch.equal(l0[k], l1[k]) for k in l0) and all(
        torch.equal(sd0[k], sd1[k]) for k in sd0)
    loss_rel = _hold_losses('remat vs plain', l1, l0, TRAIN_REPLAY_LOSS_RTOL)
    rel = _model_rel(sd1, sd0)
    stats = [k for k in sd0 if 'running' in k or 'num_batches' in k]
    stats_same = all(torch.equal(sd0[k], sd1[k]) for k in stats)
    label = f'remat {TRAIN_BACKBONE} bf16 B={TRAIN_BATCH}'
    print(f'[{label}] two steps (eager, then a replay) with and without '
          f'remat, cuDNN deterministic, dropout off: bit-identical {same} '
          f'(BN running statistics {stats_same}); losses {loss_rel:.3e} '
          f'relative (limit {TRAIN_REPLAY_LOSS_RTOL:.0e}), the model '
          f'{rel:.3e} relative (limit {TRAIN_REPLAY_MODEL_RTOL:.0e})',
          flush=True)
    if not rel <= TRAIN_REPLAY_MODEL_RTOL:
        raise RuntimeError('the remat step differs from the plain one')
    out = {}
    if card:
        print(f'[{label}] graph replay {w0:.3f} ms without remat, {w1:.3f} '
              f'ms with (median of 5); peak memory {p0:.2f} GiB without, '
              f'{p1:.2f} GiB with (max_memory_allocated over setup, eager '
              'step, capture and replays)', flush=True)
        out = dict(ms=w0, remat_ms=w1, peak_gib=p0, remat_peak_gib=p1)
        _release()
        print('[remat bench] python -m spec_tpu_torch.bench --mode train '
              '--remat', flush=True)
        if bench.main(['--mode', 'train', '--remat']) != 0:
            raise RuntimeError('the remat train bench failed')
        _release()
    return out



# The detector phase: YoloDetector at the reference's 416² in bf16 with
# its batch of 8 and the tail ladder (replays bit for bit against the
# eager body); card against CPU in fp32 (the whole decode, every row at
# its fixed index, relative to max(1, max |CPU|)); predict(frames)
# without boxes at phase 4's input with detector='yolo' (the threshold
# lowered, a host-only knob, to just under the weakest frame's best
# candidate, so every frame yields a box from the random-init detector);
# the detector's img/s at the bench's B = 32.
DET_SIZE, DET_BATCH, DET_LADDER, DET_BENCH_BATCH = 416, 8, (4, 2, 1), 32
DET_CPU = dict(size=416, batch=2)
DET_FP32_LIMIT = 1e-3
# The HRNet phase: HMR with HRNet-W32 and the conv head in the
# predictor's stage 2 (bf16, phase 4's input; replay against eager bit
# for bit), card against CPU at phase 8's small setup and limits
# (HRNET_CPU_BACKBONE for stage 2), and the SPEC train step with the
# HRNet HMR at the train phase's batch.
HRNET_BACKBONE, HRNET_CPU_BACKBONE = 'hrnet_w32-conv', 'hrnet_w32-conv'
HRNET_TRAIN_REPLAYS = 3


def _yolo_work(size, batch):
    """YOLOv3's convolution operations at ``size``² for ``batch``
    images (2 x multiply-adds; BatchNorm, activations and the decode
    left out) and the bytes of its input, weights (bf16) and candidate
    output."""
    from spec_tpu_torch.models.detector import YOLOV3_LAYERS

    flops, cin, hist, hw, params = 0.0, 3, [], size, 0
    hw_hist = []
    for spec in YOLOV3_LAYERS:
        if spec[0] == 'conv':
            _, ch, k, s, _ = spec
            hw //= s
            flops += 2.0 * cin * ch * k * k * hw * hw
            params += cin * ch * k * k
            cin = ch
        elif spec[0] == 'route':
            cin = sum(hist[i] for i in spec[1])
            hw = hw_hist[spec[1][0]]
        elif spec[0] == 'upsample':
            hw *= 2
        hist.append(cin)
        hw_hist.append(hw)
    nbytes = batch * size * size * 3 * 4 + params * 2 + batch * 256 * 5 * 4
    return flops * batch, nbytes


@contextlib.contextmanager
def _eager_detector(det):
    """``det``'s forward runs its eager body (no graph) inside."""
    graph = det._fwd
    det._fwd = graph.fn
    try:
        yield
    finally:
        det._fwd = graph


def _weakest_best_score(det, frames):
    """Just under the lowest, over ``frames``, of each frame's best
    person score: the threshold at which every frame keeps a box."""
    pending = det.detect_dispatch(frames)
    best = min(float(c[:len(p), 0, 4].min()) for p, c in pending)
    return best * (1.0 - 1e-4)


def phase_detector(device='cuda'):
    """The detector phase (see the module docstring). Returns K1's
    launches in ``predict(frames)`` without boxes and its stage-2 batch.
    ``device='cpu'`` rehearses the logic (shrink DET_* and FRAME_HW)."""
    import numpy as np
    import torch

    from spec_tpu_torch import bench
    from spec_tpu_torch.models.detector import YoloDetector, YoloV3
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.serving import SpecPredictor
    from spec_tpu_torch.utils.batching import pad_pow2

    card = device == 'cuda'
    dev = torch.device(device)
    rng = np.random.RandomState(5)
    det = YoloDetector(img_size=DET_SIZE, batch_size=DET_BATCH, seed=0,
                       device=dev)
    with torch.inference_mode():
        for B in (DET_BATCH,) + DET_LADDER:
            x = torch.from_numpy(rng.rand(B, DET_SIZE, DET_SIZE, 3).astype(
                'f4')).to(dev)
            want = det._fwd.fn(x)
            det._fwd(x)                                  # capture
            got = det._fwd(x)
            same = torch.equal(got, want)
            print(f'[detector bf16 {DET_SIZE}^2 B={B}] replay vs eager '
                  f'(B, topk, 5) = {tuple(got.shape)}: bit-identical {same}',
                  flush=True)
            if not same:
                raise RuntimeError(f'detector replay differs at B={B}')
        sigs = sorted(k[0][0][0] for k in det._fwd.signatures())
        print(f'[detector] graphs for batches {sigs}')

    # card against CPU in fp32
    sd = {k: v.cpu() for k, v in det.model.state_dict().items()}
    x = torch.from_numpy(rng.rand(DET_CPU['batch'], DET_CPU['size'],
                                  DET_CPU['size'], 3).astype('f4'))
    outs = []
    for where in (device, 'cpu'):
        model = YoloV3(torch.float32)
        model.load_state_dict(sd)
        model = model.to(where).eval()
        with torch.inference_mode():
            outs.append(model(x.to(where)).cpu())
    err = float((outs[0] - outs[1]).abs().max()) / max(
        1.0, float(outs[1].abs().max()))
    print(f'[detector card vs cpu] fp32 {DET_CPU["size"]}^2 B='
          f'{DET_CPU["batch"]}: raw decode {tuple(outs[1].shape)}, every '
          f'row at its index: max |difference| {err:.3e} of max(1, max '
          f'|cpu|) (limit {DET_FP32_LIMIT:.0e})', flush=True)
    if not err <= DET_FP32_LIMIT:
        raise RuntimeError('the detector on the card disagrees with the CPU')
    del det, outs
    if card:
        _release()

    # predict(frames) without boxes, the detector in the predictor
    frames, _ = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    pred = SpecPredictor(
        device=dev, backbone='resnet50', camcalib_backbone='resnet50',
        use_cam_feats=True, img_res=224, min_size=600,
        batch_size=BATCH_SIZE, dtype=torch.bfloat16, detector='yolo')
    pred.detector.conf_thresh = _weakest_best_score(pred.detector, frames)
    boxes = pred.detector.detect(frames)
    n_persons = sum(len(b) for b in boxes)
    pred.predict(frames)                                 # captures
    L.LAUNCHES = 0
    got = pred.predict(frames, return_cameras=True)
    launches = L.LAUNCHES
    with _eager(pred), _eager_detector(pred.detector):
        want = pred.predict(frames, return_cameras=True)
    _check_results(got[0], n_persons)
    if [len(r) for r in got[0]] != [len(b) for b in boxes] or not all(
            len(b) for b in boxes):
        raise RuntimeError(f'predict found {[len(r) for r in got[0]]} '
                           f'persons, detect {[len(b) for b in boxes]}')
    via_boxes = pred.predict(frames, boxes=boxes, return_cameras=True)
    same_boxes = _predict_diff(got, via_boxes)[0]
    print(f'[detector predict bf16] 4 frames {FRAME_HW[0]}x{FRAME_HW[1]}, '
          f'conf_thresh {pred.detector.conf_thresh:.4f}: persons per frame '
          f'{[len(b) for b in boxes]}; K1 launches {launches} in one call; '
          f'the same as predict(frames, boxes=detect(frames)) bit for bit '
          f'{same_boxes}', flush=True)
    _hold_predict('detector predict bf16', got, want, 'bf16')
    if card and launches < 1:
        raise RuntimeError('predict(frames) did not launch K1')
    if not same_boxes:
        raise RuntimeError('predict(frames) differs from predict(frames, '
                           'boxes=detect(frames))')
    out = {'launches': launches, 'persons': n_persons,
           'batch': pad_pow2(min(n_persons, BATCH_SIZE), BATCH_SIZE)}
    if card:
        wall = _wall_ms(lambda: pred.predict(frames), 5)
        seq = _wall_ms(lambda: pred.predict(
            frames, boxes=pred.detector.detect(frames)), 5)
        print(f'[detector predict bf16] {wall:.3f} ms per call '
              f'(detection and stage 1 queued before either is fetched), '
              f'{seq:.3f} ms with detect() fetched first (median of 5)',
              flush=True)
        _device_profile('detector predict bf16',
                        lambda: pred.predict(frames), wall, 3, top=6)
        out['ms'] = wall
    del pred
    if card:
        _release()
        with torch.inference_mode():
            args = bench.parse_args(['--mode', 'detect', '--batch',
                                     str(DET_BENCH_BATCH)])
            payload = bench.detect_bench(args, dev)
        bound, by = _bound(*_yolo_work(DET_SIZE, DET_BENCH_BATCH),
                           PEAK_FLOPS['bf16'])
        print(f'[detector bench] B={DET_BENCH_BATCH} {DET_SIZE}^2 bf16: '
              f'{payload["value"]:.1f} img/s, {payload["ms_per_batch"]:.3f} '
              f'ms per batch; bound {bound:.3f} ms ({by}: '
              f'{_yolo_work(DET_SIZE, 1)[0] / 1e9:.1f} GFLOP of '
              f'convolutions per image), share '
              f'{bound / payload["ms_per_batch"]:.3f}', flush=True)
        out['bench'] = payload
        _release()
    return out


def _calibrated_bn(model, res, n=16, seed=0):
    """``model``'s state_dict with every BatchNorm's running statistics
    set to those of one batch of ``n`` random crops (computed on the
    CPU). A random HRNet with unit statistics (mean 0, var 1) grows its
    activations through every exchange module, and an absolute card vs
    CPU limit would then measure that growth; with the statistics of
    its own activations each layer stays near unit scale."""
    import copy

    import torch

    m = copy.deepcopy(model).cpu().float().train()
    for bn in m.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.reset_running_stats()
            bn.momentum = None           # a cumulative average: one batch
    x = torch.randn(n, 3, res, res,
                    generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.backbone(x)
    return {k: v for k, v in m.state_dict().items()}


def phase_hrnet(device='cuda'):
    """The HRNet phase (see the module docstring). Returns K1's launches
    in one HRNet predict call and over the train replays.
    ``device='cpu'`` rehearses the logic (shrink FRAME_HW, TRAIN_*)."""
    import numpy as np
    import torch

    from spec_tpu_torch import bench
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.serving import SpecPredictor

    card = device == 'cuda'
    dev = torch.device(device)
    out = {}
    # predict with HMR-HRNet in stage 2, bf16
    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    n_persons = sum(len(b) for b in boxes)
    pred = SpecPredictor(
        device=dev, backbone=HRNET_BACKBONE, camcalib_backbone='resnet50',
        use_cam_feats=True, img_res=224, min_size=600,
        batch_size=BATCH_SIZE, dtype=torch.bfloat16)
    pred.predict(frames, boxes)                          # captures
    L.LAUNCHES = 0
    got = pred.predict(frames, boxes, return_cameras=True)
    out['predict_launches'] = L.LAUNCHES
    with _eager(pred):
        want = pred.predict(frames, boxes, return_cameras=True)
    _check_results(got[0], n_persons)
    print(f'[hrnet predict bf16] {HRNET_BACKBONE} stage 2, 4 frames '
          f'{FRAME_HW[0]}x{FRAME_HW[1]}, {n_persons} persons: K1 launches '
          f'{out["predict_launches"]} in one call', flush=True)
    _hold_predict('hrnet predict bf16', got, want, 'bf16')
    if card and out['predict_launches'] != 1:
        raise RuntimeError('the HRNet predict call launched K1 '
                           f'{out["predict_launches"]} times')
    if card:
        wall = _wall_ms(lambda: pred.predict(frames, boxes), 5)
        with torch.inference_mode():
            frames_dev = [pred._upload(f) for f in frames]
            cams = pred.estimate_cameras(frames)
            (s2,) = [x for *_, x in pred._stage2_batches(frames_dev, boxes,
                                                         cams)]
            stage2 = _time_ms(lambda: pred._stage2(*s2), n=20)
        print(f'[hrnet predict bf16] {wall:.3f} ms per call (median of 5); '
              f'stage 2 alone {stage2:.3f} ms per replay at B = '
              f'{s2[0].shape[0]} (CUDA events, median of 20)', flush=True)
        _device_profile('hrnet predict bf16',
                        lambda: pred.predict(frames, boxes), wall, 3, top=6)
        out.update(predict_ms=wall, stage2_ms=stage2)
    del pred
    if card:
        _release()

    # card against CPU at phase 8's setup, HRNet in stage 2, with
    # calibrated BatchNorm statistics on both sides
    rng = np.random.RandomState(11)
    small = [(rng.rand(96, 128, 3) * 255).astype(np.uint8) for _ in range(2)]
    small_boxes = [np.array([[40.0, 55.0, 50.0, 50.0]], np.float32),
                   np.array([[60.0, 50.0, 40.0, 70.0],
                             [90.0, 40.0, 30.0, 55.0]], np.float32)]
    kw = dict(backbone=HRNET_CPU_BACKBONE, camcalib_backbone='resnet18',
              use_cam_feats=True, min_size=96, img_res=64, batch_size=8)
    sd = None
    res = []
    for where in (dev, 'cpu'):
        p = SpecPredictor(device=where, **kw)
        if sd is None:
            sd = _calibrated_bn(p.spec, 64)
        p.spec.load_state_dict(sd)
        res.append(p.predict(small, small_boxes, return_cameras=True))
    res_g, res_c = res
    _, errs, cam = _predict_diff(res_g, res_c)
    limits = PREDICT_LIMITS['fp32']
    print(f'[hrnet card vs cpu] {HRNET_CPU_BACKBONE} fp32 min_size 96 '
          f'img_res 64: camera angles {cam:.2e} rad (limit '
          f'{ANGLE_LIMIT["fp32"]}), '
          + ', '.join(f'{k} {errs[k]:.2e} (limit {lim})'
                      for k, lim in limits.items()), flush=True)
    bad = [k for k, lim in limits.items() if not errs[k] <= lim]
    if cam > ANGLE_LIMIT['fp32'] or bad:
        raise RuntimeError(f'HRNet card and CPU disagree: {bad or "cameras"}')

    # the SPEC train step with HMR-HRNet at the train phase's batch
    if card:
        torch.cuda.reset_peak_memory_stats()
    state, step, batch = bench.train_setup(
        TRAIN_BATCH, HRNET_BACKBONE, torch.bfloat16, dev, TRAIN_RES)
    head = state.model.head
    head.dropout_rate = 0.0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        step(state, batch)                       # eager first step, capture
        snap = _snapshot(state)
        _, eager = step.eager(state, batch)
        eager_sd = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}
        _restore(state, snap)
        _, replay = step(state, batch)
        rel = _model_rel(state.model.state_dict(), eager_sd)
        same = all(torch.equal(replay[k], eager[k]) for k in eager) and \
            rel == 0.0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    label = f'hrnet train step {HRNET_BACKBONE} bf16 B={TRAIN_BATCH}'
    print(f'[{label}] replay vs eager from one state (cuDNN deterministic, '
          f'dropout off): bit-identical {same}; the model after the step '
          f'{rel:.3e} relative (limit {TRAIN_REPLAY_MODEL_RTOL:.0e})',
          flush=True)
    if not rel <= TRAIN_REPLAY_MODEL_RTOL:
        raise RuntimeError('the HRNet train step replay differs from eager')
    L.LAUNCHES = 0
    losses = [float(step(state, batch)[1]['loss/total_loss'])
              for _ in range(HRNET_TRAIN_REPLAYS)]
    out['train_launches'] = L.LAUNCHES
    print(f'[{label}] {HRNET_TRAIN_REPLAYS} replays: total loss '
          + ' '.join(f'{v:.3f}' for v in losses)
          + f'; K1 launches {out["train_launches"]}', flush=True)
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f'HRNet train loss not finite: {losses}')
    if card and out['train_launches'] != \
            TRAIN_K1_PER_STEP * HRNET_TRAIN_REPLAYS:
        raise RuntimeError('the HRNet train step launched K1 '
                           f'{out["train_launches"]} times')
    if card:
        wall = _wall_ms(lambda: step(state, batch), 5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f'[{label}] graph {wall:.3f} ms per step (median of 5), '
              f'{TRAIN_BATCH / wall * 1e3:.1f} img/s, peak memory '
              f'{peak:.2f} GiB (max_memory_allocated over setup, eager '
              f'step, capture and replays)', flush=True)
        _device_profile(label, lambda: step(state, batch), wall, 3, top=6)
        out.update(train_ms=wall)
    del state, step, batch
    if card:
        _release()
    return out


def _ellipsoid_mesh(n_lon=84, n_rings=82, radii=(0.25, 0.85, 0.15)):
    """A closed ellipsoid of a body's extent (metres) with SMPL's counts,
    V = n_lon * n_rings + 2 = 6890 and F = 2 * n_lon * n_rings = 13776,
    faces wound outward: small faces like a released SMPL mesh's, where
    the synthetic test assets join random vertices."""
    import numpy as np

    theta = np.linspace(0, np.pi, n_rings + 2)[1:-1]
    phi = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing='ij')
    ring = np.stack([np.sin(t) * np.cos(p), np.cos(t),
                     np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * radii
    top, bottom = 0, len(verts) - 1

    def idx(r, k):
        return 1 + r * n_lon + k % n_lon

    faces = []
    for k in range(n_lon):
        faces.append((top, idx(0, k + 1), idx(0, k)))
        faces.append((bottom, idx(n_rings - 1, k), idx(n_rings - 1, k + 1)))
        for r in range(n_rings - 1):
            a, b = idx(r, k), idx(r, k + 1)
            c, d = idx(r + 1, k), idx(r + 1, k + 1)
            faces += [(a, b, d), (a, d, c)]
    faces = np.asarray(faces, np.int32)
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (n * tri.mean(1)).sum(1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts.astype(np.float32), faces


def _mesh_pixels(overlay, base):
    """Pixels where ``overlay`` differs from ``base`` (uint8 HxWx3)."""
    return (overlay != base).any(-1)


def _omp_threads():
    """The OpenMP thread count the raster library runs with."""
    import ctypes

    from spec_tpu_torch.ops.cuda_build import build_host_library

    lib = ctypes.CDLL(str(build_host_library('raster')[0]))
    return int(lib.omp_get_max_threads())


def _host_toolchain_facts():
    """Print whether ``g++ -fopenmp`` builds and runs a program here and
    whether ``jpeglib.h`` (and ``-ljpeg``) are found: the JPEG engine
    (``csrc/jpegroi.cpp``) builds only where they are."""
    import tempfile

    def run(cmd, src):
        try:
            proc = subprocess.run(cmd, input=src, capture_output=True,
                                  text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return False, str(e)
        return proc.returncode == 0, proc.stderr.strip().splitlines()[:1]

    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        exe = os.path.join(tmp, 'omp')
        ok, err = run(['g++', '-fopenmp', '-x', 'c++', '-', '-o', exe],
                      '#include <omp.h>\nint main() { return '
                      'omp_get_max_threads() > 0 ? 0 : 1; }\n')
        if ok:
            ok = subprocess.run([exe], timeout=60).returncode == 0
        print(f'[host] g++ -fopenmp links and runs: {"yes" if ok else "no"}'
              + ('' if ok else f' ({err})'), flush=True)
        ok, err = run(['g++', '-E', '-x', 'c++', '-'],
                      '#include <jpeglib.h>\n')
        print(f'[host] jpeglib.h found (g++ -E): {"yes" if ok else "no"}'
              + ('' if ok else f' ({err})'), flush=True)
        ok, err = run(['g++', '-x', 'c++', '-', '-ljpeg', '-o',
                       os.path.join(tmp, 'jpeg')],
                      '#include <cstdio>\n#include <jpeglib.h>\n'
                      'int main() { jpeg_error_mgr e; '
                      'jpeg_std_error(&e); return 0; }\n')
        print(f'[host] -ljpeg links: {"yes" if ok else "no"}'
              + ('' if ok else f' ({err})'), flush=True)


def _mean_head(model):
    """Zero HMR's head decoders (as the bench's train setup does): the
    random model then predicts its mean pose, shape and camera, a mesh
    centred in its box, so an overlay has a mesh in view."""
    import torch

    with torch.no_grad():
        for dec in (model.head.decpose, model.head.decshape,
                    model.head.deccam):
            dec.weight.zero_()
            dec.bias.zero_()
    return model


class _Images:
    """A TensorBoard writer stand-in that keeps the images."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, img, step))

    def flush(self):
        pass


def phase_render(build_seconds, device='cuda'):
    """Phase 20 (see the module docstring): the renderer's three paths
    and profiling. Returns K1's launches per path. ``device='cpu'``
    rehearses the logic on a machine without a card (shrink FRAME_HW,
    RENDER_BACKBONE, EVAL_* and TRAINER_* first): both sides of the
    comparison then run on the CPU and K1 counts no launch."""
    import glob

    import numpy as np
    import torch

    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.data.loader import DataLoader
    from spec_tpu_torch.eval import eval_loop
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.serving import SpecPredictor
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils import profiling
    from spec_tpu_torch.utils.renderer import render_mesh_overlay

    card = device == 'cuda'
    dev = torch.device(device)
    sync = torch.cuda.synchronize if card else (lambda: None)
    launches = {}
    kw = dict(backbone=RENDER_BACKBONE, camcalib_backbone=RENDER_BACKBONE,
              use_cam_feats=True, img_res=224, min_size=RENDER_MIN_SIZE,
              batch_size=BATCH_SIZE)
    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    n_persons = sum(len(b) for b in boxes)

    def overlays(results, cams, own=False):
        """One overlay per frame and, with ``own``, each person's own
        mesh pixels."""
        outs, pixels = [], []
        for frame, res, cam in zip(frames, results, cams):
            verts = [p['smpl_vertices'] for p in res]
            cam_t = [p['pred_cam_t'] for p in res]
            outs.append(render_mesh_overlay(
                frame, verts, cam_t, faces_np, cam['f_pix'], cam['pitch'],
                cam['roll']))
            if own:
                pixels.append([int(_mesh_pixels(render_mesh_overlay(
                    frame, [v], [t], faces_np, cam['f_pix'], cam['pitch'],
                    cam['roll']), frame).sum())
                    for v, t in zip(verts, cam_t)])
        return outs, pixels

    # (a) the demos' overlay at phase 4's input, bf16
    pred = SpecPredictor(device=device, dtype=torch.bfloat16, **kw)
    faces_np = pred.assets.faces.cpu().numpy()
    pred.predict(frames, boxes)                  # captures
    sync()
    L.LAUNCHES = 0
    results, cams = pred.predict(frames, boxes, return_cameras=True)
    sync()
    _, own = overlays(results, cams, own=True)
    launches['render demo overlay'] = L.LAUNCHES
    _check_results(results, n_persons)
    if card and L.LAUNCHES < 1:
        raise RuntimeError('the overlay path launched K1 no time')
    empty = [(fi, pi) for fi, px in enumerate(own)
             for pi, n in enumerate(px) if n == 0]
    if empty:
        raise RuntimeError(f'meshes cover no pixel: (frame, person) {empty}')
    times = []
    for _ in range(RENDER_TIMING_CALLS):
        t0 = time.perf_counter()
        for frame, res, cam in zip(frames, results, cams):
            render_mesh_overlay(frame, [p['smpl_vertices'] for p in res],
                                [p['pred_cam_t'] for p in res], faces_np,
                                cam['f_pix'], cam['pitch'], cam['roll'])
        times.append((time.perf_counter() - t0) * 1e3 / len(frames))
    render_ms = statistics.median(times)
    # the same frames and cameras with a small-faced mesh of SMPL's V, F
    ell_v, ell_f = _ellipsoid_mesh()
    ell_times = []
    for _ in range(RENDER_TIMING_CALLS):
        t0 = time.perf_counter()
        for frame, res, cam in zip(frames, results, cams):
            render_mesh_overlay(
                frame, [ell_v + p['smpl_vertices'].mean(0) for p in res],
                [p['pred_cam_t'] for p in res], ell_f, cam['f_pix'],
                cam['pitch'], cam['roll'])
        ell_times.append((time.perf_counter() - t0) * 1e3 / len(frames))
    print(f'[render overlay bf16] {RENDER_BACKBONE} x2, 4 frames '
          f'{FRAME_HW[0]}x{FRAME_HW[1]}, {n_persons} persons: K1 launches '
          f'{launches["render demo overlay"]} in the predict call; mesh '
          f'pixels per person {own}; render_mesh_overlay '
          f'{render_ms:.3f} ms per frame (host, median of '
          f'{RENDER_TIMING_CALLS}; min {min(times):.3f}, max '
          f'{max(times):.3f}) with {_omp_threads()} OpenMP threads; '
          f'raster library built in {build_seconds.get("raster", 0.0):.2f} '
          f's; an ellipsoid of V = {len(ell_v)}, F = {len(ell_f)} (small '
          f'faces) in its place: {statistics.median(ell_times):.3f} ms per '
          f'frame (min {min(ell_times):.3f}, max {max(ell_times):.3f})',
          flush=True)
    del pred
    if card:
        _release()

    # the same overlays from the card's fp32 outputs and the CPU's
    got = SpecPredictor(device=device, **kw).predict(
        frames, boxes, return_cameras=True)
    want = SpecPredictor(device='cpu', **kw).predict(
        frames, boxes, return_cameras=True)
    got_img, _ = overlays(*got)
    want_img, _ = overlays(*want)
    worst = 0.0
    for fi, (g, w) in enumerate(zip(got_img, want_img)):
        mesh = int((_mesh_pixels(g, frames[fi])
                    | _mesh_pixels(w, frames[fi])).sum())
        diff = int(_mesh_pixels(g, w).sum())
        worst = max(worst, diff / max(mesh, 1))
        print(f'[render card vs cpu fp32] frame {fi}: {diff} of {mesh} '
              f'mesh pixels differ', flush=True)
    dv = max(float(np.abs(pg['smpl_vertices'] - pc['smpl_vertices']).max())
             for rg, rc in zip(got[0], want[0]) for pg, pc in zip(rg, rc))
    print(f'[render card vs cpu fp32] worst share {worst:.2e} (limit '
          f'{RENDER_PIXEL_SHARE:.0e}); vertices {dv:.2e} m apart',
          flush=True)
    if worst > RENDER_PIXEL_SHARE:
        raise RuntimeError('the card and CPU overlays differ in '
                           f'{worst:.2e} of the mesh pixels')
    del got, want
    if card:
        _release()

    # (b) the eval step's save_images arrays
    assets = {g: S.create_test_assets(seed=i)
              for i, g in enumerate(('neutral', 'male', 'female'))}
    jreg = assets['neutral'].j_regressor_h36m.numpy()
    model = HMR(backbone=EVAL_BACKBONE, use_cam_feats=True,
                img_res=EVAL_RES, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = _mean_head(model).to(dev).eval()
    step = eval_loop.make_eval_step(model, assets, jreg, use_gender=True)
    items = _EvalItems(EVAL_BATCH, seed=3)
    batch = next(iter(DataLoader(items, batch_size=EVAL_BATCH)))
    cam_keys = ('pred_cam_rotmat', 'pred_cam_int')
    src = dict(zip(eval_loop.BATCH_KEYS, eval_loop.BATCH_KEYS),
               cam_rotmat=cam_keys[0], cam_intrinsics=cam_keys[1])
    dev_batch = {k: torch.from_numpy(np.ascontiguousarray(batch[src[k]])).to(
        dev) for k in eval_loop.BATCH_KEYS}
    step(dev_batch)                              # capture
    L.LAUNCHES = 0
    res_out, *_ = step(dev_batch)
    group = eval_loop.render_val_group(batch, res_out, assets['neutral'],
                                       cam_keys)
    launches['render eval save_images'] = L.LAUNCHES
    r = EVAL_RES
    ok = (group.shape == (r, 3 * r, 3) and group.dtype == np.float32
          and 0.0 <= group.min() and group.max() <= 1.0 + 1e-6
          and (group[:, r:2 * r] != group[:, :r]).any()
          and (group[:, 2 * r:] > 0).any())
    t0 = res_out['pred_cam_t'][0].float().cpu().numpy()
    print(f'[render save_images] eval step B={EVAL_BATCH} bf16 (mean head) '
          f'+ render_val_group: {group.shape} {group.dtype}, overlay pixels '
          f'{int((group[:, r:2 * r] != group[:, :r]).any(-1).sum())}, side '
          f'view pixels {int((group[:, 2 * r:] > 0).any(-1).sum())}, '
          f'sample 0 pred_cam_t {np.round(t0, 3).tolist()}; K1 launches '
          f'{launches["render eval save_images"]} (one replay)', flush=True)
    if not ok or (card and L.LAUNCHES != EVAL_K1_PER_STEP):
        raise RuntimeError('the save_images render is wrong')
    del model, step, dev_batch, res_out
    if card:
        _release()

    # (c) the trainer's TensorBoard grid, into a stand-in writer
    work = ROOT / 'build' / 'spec_tpu_torch' / 'render_smoke'
    cfg = _train_cfg(work, TRAINER_BACKBONE, TRAINER_BATCH, TRAIN_RES)
    cfg.LOGDIR = ''
    model = HMR(backbone=TRAINER_BACKBONE, use_cam_feats=True,
                dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = SpecTrainer(cfg, _mean_head(model).to(dev).train(),
                          {'neutral': assets['neutral']}, jreg,
                          lambda epoch: None, lambda: {})
    trainer.writer = _Images()
    items = _TrainItems(TRAINER_BATCH, TRAIN_RES, seed=8)
    batch = next(iter(DataLoader(items, batch_size=TRAINER_BATCH)))
    L.LAUNCHES = 0
    trainer._train_image_summary(batch, 1)
    launches['render tb grid'] = L.LAUNCHES
    if len(trainer.writer.images) != 1:
        raise RuntimeError('the image summary wrote no grid')
    tag, grid, _ = trainer.writer.images[0]
    r = TRAIN_RES
    print(f'[render tb grid] {tag}: {grid.shape}, mesh pixels '
          f'{int((grid[:, :, r:2 * r] != grid[:, :, :r]).any(0).sum())}; '
          f'K1 launches {launches["render tb grid"]}', flush=True)
    if (grid.shape != (3, 4 * r, 5 * r) or not np.isfinite(grid).all()
            or not (grid[:, :, r:2 * r] != grid[:, :, :r]).any()
            or not (grid[:, :, 2 * r:] > 0).any()
            or (card and L.LAUNCHES < 1)):
        raise RuntimeError('the TensorBoard grid is wrong')
    del trainer, model
    if card:
        _release()

    # (d) profiling: one predict under trace with annotated regions
    pred = SpecPredictor(device=device, dtype=torch.bfloat16, **kw)
    pred.predict(frames, boxes)
    trace_dir = ROOT / 'build' / 'spec_tpu_torch' / 'trace_smoke'
    import shutil

    shutil.rmtree(trace_dir, ignore_errors=True)
    L.LAUNCHES = 0
    with profiling.trace(str(trace_dir)):
        with profiling.annotate('smoke_predict'):
            with profiling.annotate('smoke_predict_call'):
                pred.predict(frames, boxes)
            sync()
    launches['render profiled predict'] = L.LAUNCHES
    files = glob.glob(str(trace_dir / '*.pt.trace.json'))
    if len(files) != 1:
        raise RuntimeError(f'trace files: {files}')
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name', '') for e in events}
    k1 = sum(1 for e in events if 'lbs_kernel' in e.get('name', '')
             and e.get('cat') == 'kernel')
    print(f'[profiling] trace {os.path.basename(files[0])}: '
          f'{len(events)} events, regions '
          f'{sorted(n for n in names if n.startswith("smoke_"))}, K1 kernel '
          f'events {k1}, K1 launches {L.LAUNCHES}', flush=True)
    if not {'smoke_predict', 'smoke_predict_call'} <= names or (
            card and k1 < 1):
        raise RuntimeError('the trace lacks the regions or K1')
    shutil.rmtree(trace_dir, ignore_errors=True)
    del pred
    if card:
        _release()
    _host_toolchain_facts()
    return launches


# Phase 21 (export): phase 4's predictor, exported on the card and on the
# CPU, each artifact loaded on the card.
EXPORT_BACKBONE = 'resnet50'
EXPORT_MIN_SIZE = 600
EXPORT_TIMING_CALLS = 10
# Phase 22 (datagen): spec_synth at its CLI's defaults.
SYNTH = dict(dataset='spec-syn', n=256, seed=0, hw=(256, 320), f_pix=400.0)
PANO_CROPS = 12     # the generators' crops per panorama
# card (K1) vs CPU (plain) npz columns: 3D joints in m (K1's budget),
# 2D joints and bbox centers in px (1e-5 m at 4-5 m depth and f_pix 400
# is 1e-3 px), bbox scales (max side / 200)
SYNTH_LIMITS = dict(S=LBS_BUDGET, part=5e-3, openpose=5e-3, center=5e-3,
                    scale=1e-4)


def phase_export(device='cuda'):
    """Phase 21 (see the module docstring): ``export.export_predictor``
    on the card and on the CPU, ``load_predictor`` of both artifacts on
    the card, each held to the live predictor. Returns K1's launches in
    one ``predict`` of each loaded predictor. ``device='cpu'`` rehearses
    the logic without a card (shrink FRAME_HW, EXPORT_BACKBONE and
    EXPORT_MIN_SIZE first): every side then runs on the CPU."""
    import torch

    from spec_tpu_torch import export as EX
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.serving import SpecPredictor

    card = device == 'cuda'
    sync = torch.cuda.synchronize if card else (lambda: None)
    out_dir = ROOT / 'build' / 'spec_tpu_torch' / 'export'
    out_dir.mkdir(parents=True, exist_ok=True)
    frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)
    n_persons = sum(len(b) for b in boxes)
    kw = dict(backbone=EXPORT_BACKBONE, camcalib_backbone=EXPORT_BACKBONE,
              use_cam_feats=True, img_res=224, min_size=EXPORT_MIN_SIZE,
              batch_size=BATCH_SIZE)

    def call_ms(pred):
        times = []
        for _ in range(EXPORT_TIMING_CALLS):
            sync()
            t0 = time.perf_counter()
            pred.predict(frames, boxes)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    launches = {}
    for tag, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        live = SpecPredictor(device=device, dtype=dtype, **kw)
        live.predict(frames, boxes)                  # captures
        want = live.predict(frames, boxes, return_cameras=True)
        live_ms = call_ms(live)
        exporters = {'card' if card else 'cpu': live}
        if card:
            # the same seeds give the same weights on the CPU
            exporters['cpu'] = SpecPredictor(device='cpu', dtype=dtype, **kw)
        for src, exporter in exporters.items():
            path = out_dir / f'predictor_{tag}_{src}.specx'
            t0 = time.perf_counter()
            EX.export_predictor(exporter, str(path))
            export_s = time.perf_counter() - t0
            meta = EX.read_meta(str(path))
            if meta['dtype'] != str(dtype).replace('torch.', ''):
                raise RuntimeError(f'{tag}: the artifact records dtype '
                                   f'{meta["dtype"]}')
            t0 = time.perf_counter()
            pred = EX.load_predictor(str(path), device=device)
            sync()
            load_s = time.perf_counter() - t0
            pred.predict(frames, boxes)              # captures
            sync()
            L.LAUNCHES = 0
            got = pred.predict(frames, boxes, return_cameras=True)
            sync()
            n_k1 = L.LAUNCHES
            launches[f'{tag} {src}-exported'] = n_k1
            _check_results(got[0], n_persons)
            if card and n_k1 < 1:
                raise RuntimeError(f'the {src}-exported {tag} artifact '
                                   'launched K1 no time on the card')
            same, errs, cam = _predict_diff(got, want)
            limits = PREDICT_LIMITS[tag]
            loaded_ms = call_ms(pred)
            print(f'[export {tag} {src}] {EXPORT_BACKBONE} x2: exported on '
                  f'the {src} in {export_s:.2f} s, '
                  f'{path.stat().st_size / 2 ** 20:.1f} MiB, ranges '
                  f'{meta["ranges"]}; loaded on the {device} in '
                  f'{load_s:.2f} s; predict on 4 frames {FRAME_HW[0]}x'
                  f'{FRAME_HW[1]}, {n_persons} persons: loaded '
                  f'{loaded_ms:.2f} ms, live {live_ms:.2f} ms (median of '
                  f'{EXPORT_TIMING_CALLS}); K1 launches {n_k1} in one call; '
                  f'vs live: bit-identical {same}, camera angles '
                  f'{cam:.2e} rad (limit {ANGLE_LIMIT[tag]}), '
                  + ', '.join(f'{k} {errs[k]:.2e} (limit {lim})'
                              for k, lim in limits.items()), flush=True)
            bad = [k for k, lim in limits.items() if not errs[k] <= lim]
            if cam > ANGLE_LIMIT[tag] or bad:
                raise RuntimeError(f'the {src}-exported {tag} artifact '
                                   f'disagrees with the live predictor '
                                   f'in {bad or "cameras"}')
            del pred
        del live, exporters
        if card:
            _release()
    return launches


def _pano_crops(root):
    """Both Pano360 generators over one structured 1024x2048 panorama
    (PANO_CROPS crops each, one thread): ms per crop on this host."""
    import cv2
    import numpy as np

    from spec_tpu_torch.datagen import pano_preprocessing, scalenet

    pano_dir = root / 'panos'
    pano_dir.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[:1024, :2048].astype(np.float32)
    img = np.stack([xx / 8, yy / 4, 127 + 100 * np.sin(xx / 37)], -1)
    img += np.random.RandomState(0).randn(1024, 2048, 3) * 10
    pano = str(pano_dir / 'p0.jpg')
    cv2.imwrite(pano, np.clip(img, 0, 255).astype(np.uint8))
    for name, fn in (('pano_preprocessing',
                      pano_preprocessing.preprocess_calib_data),
                     ('scalenet', scalenet.generate_calibration_dataset)):
        t0 = time.perf_counter()
        splits = fn([pano], str(root / name), crops_per_pano=PANO_CROPS,
                    seed=0, workers=1)
        ms = (time.perf_counter() - t0) * 1e3 / PANO_CROPS
        n = sum(len(v) for v in splits.values())
        if n != PANO_CROPS:
            raise RuntimeError(f'{name} wrote {n} of {PANO_CROPS} crops')
        print(f'[datagen {name}] cv2 and joblib import here: {n} crops of '
              f'a 1024x2048 panorama, {ms:.2f} ms per crop (host, one '
              'thread, decode and JPEG writes included)', flush=True)


def phase_datagen(device='cuda'):
    """Phase 22 (see the module docstring): ``render_spec_synth_dataset``
    at its CLI's defaults with SMPL on the card and frames kept in
    memory, held to the same call on the CPU. Returns K1's launches in
    the card's call. ``device='cpu'`` rehearses the logic without a card
    (shrink SYNTH first)."""
    import numpy as np
    import torch

    from spec_tpu_torch.datagen import spec_synth
    from spec_tpu_torch.ops import lbs as L

    card = device == 'cuda'
    root = ROOT / 'build' / 'spec_tpu_torch' / 'datagen'
    frames, npz, timings = {}, {}, {}

    def run(tag, dev):
        frames[tag] = {}
        timings[tag] = {}
        npz[tag] = dict(np.load(spec_synth.render_spec_synth_dataset(
            str(root / tag), device=dev, timings=timings[tag],
            writer=lambda img, path, q: frames[tag].update(
                {os.path.basename(path): img}), **SYNTH)))

    run('warm-up', device)                 # loads the libraries
    L.LAUNCHES = 0
    run(device, device)
    launches = L.LAUNCHES
    if card and launches < 1:
        raise RuntimeError('spec_synth launched K1 no time on the card')
    run('cpu ref', 'cpu')
    n = SYNTH['n']
    got, want = npz[device], npz['cpu ref']
    errs = {}
    for k in want:
        if k in SYNTH_LIMITS:
            errs[k] = float(np.abs(got[k] - want[k]).max())
        elif not np.array_equal(got[k], want[k]):
            raise RuntimeError(f'spec_synth column {k} differs between '
                               f'the {device} and the CPU')
    worst = 0.0
    for name, w in frames['cpu ref'].items():
        g = frames[device][name]
        # the textured ground is gray (equal channels), the shaded mesh
        # is not
        mesh = (g[..., 0] != g[..., 1]) | (w[..., 0] != w[..., 1])
        diff = (g != w).any(-1)
        worst = max(worst, float(diff.sum()) / max(int(mesh.sum()), 1))
    t = timings[device]
    print(f'[datagen spec_synth] n = {n}, {SYNTH["hw"][0]}x'
          f'{SYNTH["hw"][1]}, f_pix {SYNTH["f_pix"]}, SMPL on the {device}: '
          f'K1 launches {launches} (one batch of {n}); SMPL and '
          f'projection {t["smpl_s"] * 1e3:.2f} ms; render '
          f'{t["render_s"] * 1e3 / n:.3f} ms per frame (host, raster.cpp, '
          f'in-memory writer); vs the CPU: '
          + ', '.join(f'{k} {errs[k]:.2e} (limit {SYNTH_LIMITS[k]})'
                      for k in SYNTH_LIMITS)
          + f'; frames differ in at most {worst:.2e} of their mesh '
          f'pixels (limit {RENDER_PIXEL_SHARE:.0e})', flush=True)
    bad = [k for k in SYNTH_LIMITS if not errs[k] <= SYNTH_LIMITS[k]]
    if bad or worst > RENDER_PIXEL_SHARE:
        raise RuntimeError(f'spec_synth on the {device} and the CPU '
                           f'disagree: {bad or "frames"}')
    missing = []
    for mod in ('cv2', 'joblib'):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    if missing:
        print(f'[datagen] not importable here: {", ".join(missing)}; the '
              'Pano360 crop generators (pano_preprocessing, scalenet: '
              'cv2.remap, joblib split lists) cannot run on this machine; '
              'spec_synth wrote its frames in memory above', flush=True)
    else:
        _pano_crops(root)
    try:
        import requests  # noqa: F401
        print('[datagen] requests imports here (the Flickr downloader '
              'needs it and a network)', flush=True)
    except ImportError:
        print('[datagen] requests does not import here: the Flickr '
              'downloader cannot run', flush=True)
    return launches


# Phase 23 (parallel): the SPEC train step at full width (ResNet-50 HMR
# with camera features, bf16, V = 6890) on a global batch of PAR_BATCH
# 224² crops whose halves hold different numbers of has_smpl and
# has_pose_3d rows (PAR_HAS_SMPL, PAR_HAS_3D of each half), dropout off.
# SGD with the global-norm clip at 1: each update is the gradient over
# its norm times the rate, linear in the gradient up to that one scale
# (Adam turns the float noise of a near-zero gradient into a whole +-lr
# step), so the update holds the gradient to its limit.
PAR_BATCH, PAR_STEPS, PAR_RES = 64, 3, 224
PAR_BACKBONE, PAR_VERTICES = 'resnet50', 6890
PAR_HAS_SMPL, PAR_HAS_3D = (0.75, 0.25), (0.5, 1.0)
PAR_LR = 1e-2
PAR_TIMEOUT = 600            # s, each subprocess of the phase
PAR_REPLAYS = 10             # timed replays of the one-rank NCCL step
# Two ranks over gloo on one card against one process over the same
# global batches (bf16 autocast, so the convolutions of 32 and of 64 rows
# round differently): each loss within PAR_LOSS_RTOL relative; the
# update of the whole model (got - start against want - start, L2 over
# every tensor) within PAR_UPDATE_RTOL relative; the largest parameter
# difference within PAR_UPDATE_RTOL of the largest update entry.
PAR_LOSS_RTOL, PAR_UPDATE_RTOL = 1e-2, 5e-2
# the CLIs' tiny inputs: frames, crops, the backbone
PAR_CLI_HW, PAR_CLI_RES, PAR_CLI_BACKBONE = (120, 160), 64, 'resnet18'


def _par_setup(B, device, backbone, res, vertices):
    """The phase's model, SGD state, step and global batch (numpy) on
    ``device``: ``bench.train_setup``'s HMR (seed 0, zeroed decoders),
    bf16, dropout off."""
    import numpy as np
    import torch

    from spec_tpu_torch import bench
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.train import create_train_state, make_spec_train_step
    from spec_tpu_torch.train.state import Transform

    model = HMR(backbone=backbone, use_cam=True, use_cam_feats=True,
                dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for dec in (model.head.decpose, model.head.decshape,
                    model.head.deccam):
            dec.weight.zero_()
            dec.bias.zero_()
    model.head.dropout_rate = 0.0
    model = model.to(device).train()
    state = create_train_state(model, Transform('sgd', PAR_LR,
                                                clip_norm=1.0))
    step = make_spec_train_step(model, S.create_test_assets(vertices))
    batch = bench.train_inputs(B, res)
    half = B // 2
    for key, shares in (('has_smpl', PAR_HAS_SMPL),
                        ('has_pose_3d', PAR_HAS_3D)):
        col = np.zeros(B, 'f4')
        for h, share in enumerate(shares):
            col[h * half:h * half + int(share * half)] = 1.0
        batch[key] = col
    return state, step, batch


def _par_steps(state, step, batch, n, device):
    """``n`` steps on ``batch`` (tensors on ``device``): the losses of
    each and the ms of each (host clock around a synchronized call)."""
    import torch

    losses, ms = [], []
    for _ in range(n):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        losses.append({k: float(v) for k, v in metrics.items()})
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _par_rank(argv):
    """One rank of phase 23(a): ``chip_smoke.py --parallel-rank RANK
    WORLD PORT DIR DEVICE SIZES`` (SIZES: batch,res,vertices,backbone).
    Joins a gloo group, steps on its slice of the global batch and writes
    ``DIR/rank{RANK}.pt``."""
    import torch

    from spec_tpu_torch import parallel as par
    from spec_tpu_torch.ops import lbs as L

    rank, world, port, d, device, sizes = argv[:6]
    rank, world = int(rank), int(world)
    B, res, vertices, backbone = sizes.split(',')
    par.initialize_multihost(f'127.0.0.1:{port}', world, rank,
                             backend='gloo', device=device)
    dev = par.local_device(device)
    state, step, batch = _par_setup(int(B), dev, backbone, int(res),
                                    int(vertices))
    local = par.shard_batch({k: torch.from_numpy(v)
                             for k, v in batch.items()}, [dev])[0]
    # the gradient all-reduce alone, on a buffer of the model's size
    flat = torch.ones(sum(p.numel() for p in state.optimizer.params),
                      device=dev)
    ar_ms = []
    for _ in range(4):
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        torch.distributed.all_reduce(flat)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        ar_ms.append((time.perf_counter() - t0) * 1e3)
    L.LAUNCHES = 0
    losses, ms = _par_steps(state, step, local, PAR_STEPS, dev)
    out = {'rows': len(local['img']), 'mode': step.mode,
           'backend': par.backend(), 'device': str(dev),
           'launches': L.LAUNCHES, 'losses': losses, 'ms': ms,
           'allreduce_ms': statistics.median(ar_ms[1:]),
           'allreduce_bytes': flat.numel() * 4,
           'state': {k: v.detach().cpu()
                     for k, v in state.model.state_dict().items()}}
    torch.save(out, os.path.join(d, f'rank{rank}.pt'))
    par.barrier()
    return 0


def _spawn(args, label, env=None, timeout=PAR_TIMEOUT):
    """Start ``args`` (a list) as processes of their own, wait for each
    within ``timeout`` s and return their outputs; a nonzero exit
    raises. Every process is killed on the way out."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(ROOT)) for a in args]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f'{label} process {i} exited '
                               f'{p.returncode}:\n{log[-4000:]}')
    return logs


def _free_port():
    import socket

    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _update_errors(got, want, start):
    """(relative L2 of the update difference over the whole model, the
    largest |parameter difference|, the largest |update| entry) of two
    state_dicts from one start."""
    import torch

    num = den = 0.0
    worst = biggest = 0.0
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        g, w, s = (t.double().cpu() for t in (got[k], w, start[k]))
        num += float(((g - w) ** 2).sum())
        den += float(((w - s) ** 2).sum())
        worst = max(worst, float((g - w).abs().max()))
        biggest = max(biggest, float((w - s).abs().max()))
    return (num / max(den, 1e-300)) ** 0.5, worst, biggest


def _par_two_ranks(device, sizes, d):
    """23(a): two gloo ranks on the one card against one process."""
    import torch

    B, res, vertices, backbone = sizes
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    spec = ','.join(str(x) for x in sizes)
    logs = _spawn([[sys.executable, str(ROOT / 'chip_smoke.py'),
                    '--parallel-rank', str(r), '2', str(port), str(d),
                    device, spec] for r in range(2)], 'parallel rank',
                  env=env)
    ranks = [torch.load(os.path.join(d, f'rank{r}.pt'), weights_only=False)
             for r in range(2)]
    for r, log in enumerate(logs):
        for line in log.strip().splitlines()[-3:]:
            print(f'[parallel rank {r}] {line}')
    dev = torch.device(device)
    state, step, batch = _par_setup(B, dev, backbone, res, vertices)
    start = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    full = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    losses, ms = _par_steps(state, step, full, PAR_STEPS, dev)
    want = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    del state, step, full
    _release_if(device)
    r0, r1 = ranks
    if r0['losses'] != r1['losses'] or any(
            not torch.equal(r0['state'][k], r1['state'][k])
            for k in r0['state']):
        raise RuntimeError('the two ranks disagree on the losses or the '
                           'parameters')
    worst_loss = 0.0
    for i, (got, ref) in enumerate(zip(r0['losses'], losses)):
        for k, v in ref.items():
            worst_loss = max(worst_loss, abs(got[k] - v) / max(abs(v),
                                                               1e-6))
        print(f'[parallel 2 ranks] step {i + 1}: total loss '
              f'{got["loss/total_loss"]:.6f} (two ranks) against '
              f'{ref["loss/total_loss"]:.6f} (one process)')
    upd, worst, biggest = _update_errors(r0['state'], want, start)
    print(f'[parallel 2 ranks] {backbone} bf16, global B={B} '
          f'({r0["rows"]} a rank, has_smpl {PAR_HAS_SMPL}, has_pose_3d '
          f'{PAR_HAS_3D} of each half), {PAR_STEPS} SGD steps, {r0["backend"]}'
          f' on {r0["device"]} and {r1["device"]}, the step '
          f'{r0["mode"]}: losses within {worst_loss:.3e} relative of one '
          f'process (limit {PAR_LOSS_RTOL:.0e}); the model update '
          f'{upd:.3e} relative (limit {PAR_UPDATE_RTOL:.0e}); the largest '
          f'parameter difference {worst:.3e} against the largest update '
          f'entry {biggest:.3e} (limit {PAR_UPDATE_RTOL:.0e} of it)',
          flush=True)
    print(f'[parallel 2 ranks] ms per step (rank 0): '
          + ' '.join(f'{t:.1f}' for t in r0['ms'])
          + f'; one process over the global batch: '
          + ' '.join(f'{t:.1f}' for t in ms)
          + f'; K1 forward launches per rank {r0["launches"]} and '
          f'{r1["launches"]} over {PAR_STEPS} steps (2 a step; its '
          'closed-form backward is torch operations, once a step); the '
          f'gradient all-reduce alone ({r0["allreduce_bytes"] / 1e6:.1f} MB'
          f' fp32, gloo through the host) {r0["allreduce_ms"]:.1f} ms',
          flush=True)
    if not (worst_loss <= PAR_LOSS_RTOL and upd <= PAR_UPDATE_RTOL
            and worst <= PAR_UPDATE_RTOL * biggest):
        raise RuntimeError('two ranks differ from one process beyond the '
                           'limits')
    if r0['mode'] != 'eager' or r0['backend'] != 'gloo':
        raise RuntimeError('the gloo step did not run its eager body')
    if device == 'cuda' and r0['launches'] != 2 * PAR_STEPS:
        raise RuntimeError(f'rank 0 launched K1 {r0["launches"]} times')
    return {'rank 0': r0['launches'], 'rank 1': r1['launches']}


def _release_if(device):
    if device == 'cuda':
        _release()


def _par_nccl(device, sizes):
    """23(b): one rank over NCCL (gloo in a CPU rehearsal) against the
    step without a process group: bit for bit, one graph each, and the
    all-reduce inside the graph."""
    import torch

    from spec_tpu_torch import parallel as par
    from spec_tpu_torch.ops import lbs as L

    B, res, vertices, backbone = sizes
    card = device == 'cuda'
    dev = torch.device(device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = _par_setup(B, dev, backbone, res, vertices)
        full = {k: torch.from_numpy(v).to(dev) for k, v in plain[2].items()}
        want, _ = _par_steps(plain[0], plain[1], full, PAR_STEPS, dev)
        par.initialize_multihost(f'127.0.0.1:{_free_port()}', 1, 0,
                                 backend='nccl' if card else 'gloo',
                                 device=device)
        try:
            grouped = _par_setup(B, dev, backbone, res, vertices)
            # count the all-reduces the step's body calls (its first call
            # runs it eagerly, the second captures it)
            calls = []
            all_reduce = torch.distributed.all_reduce

            def counted(*a, **k):
                calls.append(torch.cuda.is_current_stream_capturing()
                             if card else False)
                return all_reduce(*a, **k)

            torch.distributed.all_reduce = counted
            try:
                L.LAUNCHES = 0
                got, _ = _par_steps(grouped[0], grouped[1], full,
                                    PAR_STEPS, dev)
            finally:
                torch.distributed.all_reduce = all_reduce
            launches = L.LAUNCHES
            sd_got = grouped[0].model.state_dict()
            same = got == want and all(
                torch.equal(v, sd_got[k])
                for k, v in plain[0].model.state_dict().items())
            graphs = len(grouped[1].graphs.signatures())
            print(f'[parallel nccl 1 rank] {par.backend()}, the step '
                  f'{grouped[1].mode}, {graphs} graph(s) captured; the '
                  f'body called all_reduce {len(calls)} times, '
                  f'{sum(calls)} of them inside the capture; '
                  f'{PAR_STEPS} steps equal the step without a process '
                  f'group bit for bit: {same}; K1 launches {launches}',
                  flush=True)
            if not same:
                raise RuntimeError('the one-rank step differs from the '
                                   'step without a process group')
            if not card:
                return {'nccl 1 rank': launches}
            if graphs != 1 or grouped[1].mode != 'graph' or not any(calls):
                raise RuntimeError('the NCCL step is not one graph with '
                                   'its all-reduce')
            wall = {}
            for label, (state, step, _) in (('plain', plain),
                                            ('nccl', grouped),
                                            ('plain', plain),
                                            ('nccl', grouped)):
                wall.setdefault(label, []).append(_wall_ms(
                    lambda: step(state, full), PAR_REPLAYS))
            prof = _device_profile('parallel nccl 1 rank replay',
                                   lambda: grouped[1](grouped[0], full),
                                   min(wall['nccl']), 3)
            nccl = sum(n for name, n in prof['count_by_name'].items()
                       if 'nccl' in name.lower())
            print(f'[parallel nccl 1 rank] ms per step replay (median of '
                  f'{PAR_REPLAYS}, two turns): '
                  + ', '.join(f'{k} ' + ' '.join(f'{t:.3f}' for t in v)
                              for k, v in wall.items())
                  + f'; NCCL kernels the profiler names per replay '
                  f'{nccl:g} (one rank: NCCL may reduce in place without '
                  'one)', flush=True)
            return {'nccl 1 rank': launches}
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        _release_if(device)


def _par_predict(device, make_predictor, frames, boxes):
    """23(c): ``SpecPredictor(data_parallel=True)`` with the card's own
    device list (count 1) against the plain predictor, bit for bit; then
    with the device-list seam giving two replicas on the one card (the
    split and the gather run on it), within phase 8's limits."""
    import numpy as np
    import torch

    from spec_tpu_torch import parallel as par
    from spec_tpu_torch.ops import lbs as L

    plain = make_predictor(False)
    want = plain.predict(frames, boxes)
    if device == 'cuda':
        print(f'[parallel predict] the plain predictor: '
              f'{_wall_ms(lambda: plain.predict(frames, boxes), 5):.3f} ms '
              'per call (median of 5)', flush=True)
    del plain
    _release_if(device)
    launches = {}
    create_mesh = par.create_mesh
    two = [torch.device('cuda', 0) if device == 'cuda'
           else torch.device('cpu')] * 2
    for label, mesh in (('1 device', None), ('2 replicas', two)):
        if mesh is not None:
            par.create_mesh = lambda devices=None, device=None: list(mesh)
        try:
            pred = make_predictor(True)
        finally:
            par.create_mesh = create_mesh
        n_dev = len(pred.mesh)
        pred.predict(frames, boxes)                 # capture
        L.LAUNCHES = 0
        got = pred.predict(frames, boxes)
        n_k1 = launches[f'data_parallel predict ({label})'] = L.LAUNCHES
        diff = max(float(np.abs(np.asarray(g[k], np.float64)
                                - np.asarray(w[k], np.float64)).max())
                   for rg, rw in zip(got, want) for g, w in zip(rg, rw)
                   for k in w if k != 'camera')
        same = diff == 0.0 and all(
            g['camera'] == w['camera']
            for rg, rw in zip(got, want) for g, w in zip(rg, rw))
        print(f'[parallel predict] data_parallel with {n_dev} '
              f'replica(s) of each stage ({label}), {PAR_BACKBONE} fp32, '
              f'phase 4\'s input: against the plain predictor '
              + ('bit for bit' if same else f'max |diff| {diff:.3e}')
              + f'; K1 launches in one call {n_k1} (one per replica\'s '
              'stage-2 chunk)', flush=True)
        if device == 'cuda':
            print(f'[parallel predict] data_parallel ({label}): '
                  f'{_wall_ms(lambda: pred.predict(frames, boxes), 5):.3f}'
                  ' ms per call (median of 5)', flush=True)
        if mesh is None and not same:
            raise RuntimeError('data_parallel over one device differs from '
                               'the plain predictor')
        if mesh is not None:
            _within_predict_limits(got, want)
            if device == 'cuda' and n_k1 != n_dev:
                raise RuntimeError(f'{n_k1} K1 launches for {n_dev} '
                                   'replicas')
        del pred
        _release_if(device)
    return launches


def _within_predict_limits(got, want):
    """Phase 8's fp32 limits (PREDICT_LIMITS) on every person's outputs."""
    import numpy as np

    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            raise RuntimeError('person counts differ')
        for g, w in zip(rg, rw):
            for k, lim in PREDICT_LIMITS['fp32'].items():
                d = float(np.abs(np.asarray(g[k]) - np.asarray(w[k])).max())
                if not d <= lim:
                    raise RuntimeError(f'data_parallel {k} differs by {d} '
                                       f'(limit {lim})')


def _par_write_data(root, n_train=2, n_val=4):
    """A tiny data root: ``n_train`` spec-syn training samples and
    ``n_val`` 3dpw-test-cam samples (PNG frames with cv2 and their npz
    annotations, the registry's layout)."""
    import cv2
    import numpy as np

    rng = np.random.RandomState(11)
    h, w = PAR_CLI_HW
    extras = os.path.join(root, 'dataset_extras')
    os.makedirs(extras, exist_ok=True)
    for name, folder, npz, n in (
            ('spec-syn', 'spec-syn', 'spec-syn_camcalib.npz', n_train),
            ('3dpw-test-cam', '3dpw', '3dpw_test_cam_camcalib.npz', n_val)):
        img_dir = os.path.join(root, 'dataset_folders', folder)
        os.makedirs(img_dir, exist_ok=True)
        names = []
        for i in range(n):
            names.append(f'f{i}.png')
            cv2.imwrite(os.path.join(img_dir, names[-1]),
                        (rng.rand(h, w, 3) * 255).astype('u1'))
        cols = dict(
            imgname=np.array(names),
            scale=(rng.rand(n) * 0.3 + 0.4).astype('f4'),
            center=np.stack([rng.rand(n) * 60 + 50, rng.rand(n) * 40 + 40],
                            1).astype('f4'),
            shape=(rng.randn(n, 10) * 0.5).astype('f4'),
            S=rng.randn(n, 24, 4).astype('f4'),
            part=np.concatenate([rng.rand(n, 24, 2) * 100,
                                 np.ones((n, 24, 1))], -1).astype('f4'))
        if name == 'spec-syn':
            # the columns of the trainer tests' synthetic set
            cols.update(
                pose=(rng.randn(n, 72) * 0.2).astype('f4'),
                has_smpl=np.ones(n, 'f4'),
                openpose=np.concatenate([rng.rand(n, 25, 2) * 100,
                                         rng.rand(n, 25, 1)],
                                        -1).astype('f4'),
                gender=np.array(['m', 'f'] * (n // 2)),
                cam_rotmat=np.tile(np.eye(3, dtype='f4'), (n, 1, 1)),
                cam_pitch=(rng.randn(n) * 0.1).astype('f4'),
                cam_roll=(rng.randn(n) * 0.1).astype('f4'),
                focal_length=(rng.rand(n) * 300 + 400).astype('f4'))
        else:
            # the columns of the eval golden's fixture
            cols.update(
                cam_int=np.tile(np.array([[500, 0, 80], [0, 500, 60],
                                          [0, 0, 1]], 'f4'), (n, 1, 1)),
                pose_0yaw_inverseyz=(rng.randn(n, 72) * 0.2).astype('f4'),
                pose_cam=(rng.randn(n, 72) * 0.2).astype('f4'),
                camcalib_pitch=(rng.randn(n) * 0.1).astype('f4'),
                camcalib_roll=(rng.randn(n) * 0.05).astype('f4'),
                camcalib_vfov=(rng.rand(n) * 0.5 + 0.6).astype('f4'),
                camcalib_f_pix=(rng.rand(n) * 200 + 400).astype('f4'))
        np.savez(os.path.join(extras, npz), **cols)


def _par_clis(device, d):
    """23(d): ``spec_eval --data_parallel``, ``serve --data_parallel``
    and ``spec_train`` with two ranks for one step, each its own process
    on tiny inputs, each exiting 0."""
    import json
    import urllib.request

    import numpy as np

    root = os.path.join(d, 'data')
    _par_write_data(root)
    env = dict(os.environ, SPEC_DATA_ROOT=root, OMP_NUM_THREADS='1')
    opts = ['HMR.BACKBONE', PAR_CLI_BACKBONE, 'DATASET.IMG_RES',
            str(PAR_CLI_RES), 'DATASET.NUM_WORKERS', '1',
            'DATASET.VAL_DS', '3dpw-test-cam', 'DATASET.BATCH_SIZE', '2',
            'LOG_FREQ_TB_IMAGES', '0']
    py = [sys.executable, '-m']
    t0 = time.perf_counter()
    log, = _spawn([py + ['spec_tpu_torch.cli.spec_eval', '--data_parallel',
                         '--device', device, '--log_root',
                         os.path.join(d, 'eval'), '--opts', *opts,
                         # no results pickle: joblib is not on every host
                         'TESTING.USE_GT_CAM', 'True',
                         'TESTING.SAVE_RESULTS', 'False']],
                  'spec_eval --data_parallel', env=env)
    if 'data_parallel over' not in log or '"3dpw-test-cam"' not in log:
        raise RuntimeError(f'spec_eval --data_parallel:\n{log[-3000:]}')
    print(f'[parallel cli] spec_eval --data_parallel: exit 0 in '
          f'{time.perf_counter() - t0:.1f} s; '
          + next(line for line in log.splitlines()
                 if 'data_parallel over' in line), flush=True)

    t0 = time.perf_counter()
    port = _free_port()
    train = [py + ['spec_tpu_torch.cli.spec_train', '--device', device,
                   '--fdr', '--coordinator_address', f'127.0.0.1:{port}',
                   '--num_processes', '2', '--process_id', str(r),
                   '--dist_backend', 'gloo', '--log_root',
                   os.path.join(d, 'train'), '--opts', *opts,
                   'DATASET.TRAIN_DS', 'spec-syn',
                   'TRAINING.LOG_SAVE_INTERVAL', '1'] for r in range(2)]
    logs = _spawn(train, 'spec_train (2 ranks)', env=env)
    steps = [line for line in logs[0].splitlines() if ' step 1 ' in line]
    if not steps or 'its eager body' not in logs[0]:
        raise RuntimeError(f'spec_train (2 ranks):\n{logs[0][-3000:]}')
    print(f'[parallel cli] spec_train, 2 ranks over gloo, --fdr: exit 0 in '
          f'{time.perf_counter() - t0:.1f} s; {steps[0].strip()}',
          flush=True)

    t0 = time.perf_counter()
    cfg = os.path.join(d, 'serve.yaml')
    with open(cfg, 'w') as f:
        f.write(f'HMR:\n  BACKBONE: {PAR_CLI_BACKBONE}\n')
    proc = subprocess.Popen(
        py + ['spec_tpu_torch.cli.serve', '--data_parallel', '--device',
              device, '--host', '127.0.0.1', '--port', '0', '--cfg', cfg,
              '--min_size', '96', '--batch_size', '4'],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if 'listening on' in line:
                break
        else:
            raise RuntimeError('serve --data_parallel:\n' + ''.join(lines))
        base = 'http://' + line.split('listening on ')[1].split()[0]
        frames = _synthetic_frames(2, PAR_CLI_HW, 5)
        boxes = [np.array([[80., 60., 60., 90.]], 'f4')] * 2
        req = urllib.request.Request(base + '/predict',
                                     data=_npz_body(frames, boxes))
        with urllib.request.urlopen(req, timeout=PAR_TIMEOUT) as r:
            status, body = r.status, r.read()
        with urllib.request.urlopen(base + '/stats', timeout=60) as r:
            stats = json.loads(r.read())
        proc.terminate()
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if status != 200 or proc.returncode != 0:
        raise RuntimeError(f'serve --data_parallel: status {status}, exit '
                           f'{proc.returncode}:\n{"".join(lines)}{rest}')
    print(f'[parallel cli] serve --data_parallel: one request of 2 frames '
          f'answered (status {status}, {len(body)} bytes; /stats '
          f'{stats}), SIGTERM, exit 0 in {time.perf_counter() - t0:.1f} s',
          flush=True)


def phase_parallel(device='cuda'):
    """Phase 23 (see the module docstring). Returns K1's launches per
    path for the kernels line. ``device='cpu'`` rehearses its logic on a
    machine without a card (shrink PAR_BATCH, PAR_RES, PAR_BACKBONE,
    PAR_VERTICES and FRAME_HW first); the NCCL rank is then a gloo one
    and the kernel counts are 0."""
    import shutil
    import tempfile

    import torch

    d = tempfile.mkdtemp(prefix='parallel_', dir=str(ROOT / 'build'))
    sizes = (PAR_BATCH, PAR_RES, PAR_VERTICES, PAR_BACKBONE)
    try:
        print(f'[parallel] torch {torch.__version__}; NCCL '
              f'{torch.distributed.is_nccl_available()}, gloo '
              f'{torch.distributed.is_gloo_available()}; cards '
              f'{torch.cuda.device_count()}', flush=True)
        _release_if(device)
        launches = {f'parallel train {k} (gloo)': v for k, v in
                    _par_two_ranks(device, sizes, d).items()}
        launches.update(_par_nccl(device, sizes))
        frames, boxes = _frames_and_boxes(4, PERSONS_PER_FRAME, seed=0)

        def make(data_parallel):
            from spec_tpu_torch.serving import SpecPredictor

            return SpecPredictor(
                device=device, backbone=PAR_BACKBONE,
                camcalib_backbone=PAR_BACKBONE, use_cam_feats=True,
                img_res=224, min_size=600 if device == 'cuda' else 96,
                batch_size=BATCH_SIZE, data_parallel=data_parallel)

        launches.update(_par_predict(device, make, frames, boxes))
        _par_clis(device, d)
        return launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    import torch

    if '--parallel-rank' in sys.argv[1:]:      # one rank of phase 23(a)
        sys.path.insert(0, str(ROOT))
        return _par_rank(sys.argv[sys.argv.index('--parallel-rank') + 1:])
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
    build_seconds = phase_build()
    if '--profile' in sys.argv[1:]:
        phase_profile()
        return 0
    if '--k3-tiles' in sys.argv[1:]:
        phase_k3_tiles()
        return 0
    if '--k3-ab' in sys.argv[1:]:
        phase_k3_ab(sys.argv[sys.argv.index('--k3-ab') + 1])
        return 0
    if '--render' in sys.argv[1:]:
        print(json.dumps(phase_render(build_seconds)))
        return 0
    if '--export' in sys.argv[1:]:
        print(json.dumps({**phase_export(),
                          'spec_synth': phase_datagen()}))
        return 0
    if '--parallel' in sys.argv[1:]:
        print(json.dumps(phase_parallel()))
        return 0
    from spec_tpu_torch.utils.batching import pad_pow2

    k3_rows = phase_bottleneck()
    pred = phase_predictor()
    pipe = phase_pipeline()
    det = phase_detector()
    hrnet = phase_hrnet()
    # K1 at the batches the paths gave it: the predictor's one padded
    # stage-2 chunk, the detector path's, the pipeline's rows of SMPL (K1
    # wrote its vertices) and the train step's batch.
    main_batch = pad_pow2(min(sum(PERSONS_PER_FRAME), BATCH_SIZE),
                          BATCH_SIZE)
    pipe_batch = pipe['bf16']['fused']['outs'][0].shape[0]
    # (phase 23's paths: a rank's half of the train batch, a replica's
    # half of the predictor's chunk)
    lbs_rows = phase_lbs(sorted(set(LBS_BATCHES)
                                | {main_batch, pipe_batch, TRAIN_BATCH,
                                   det['batch'], SYNTH['n'],
                                   PAR_BATCH // 2, main_batch // 2}))
    verts, _, cam_t, vfov, pitch, roll = pipe['fp32']['fused']['outs']
    k2 = phase_projection(_projection_operands(verts, cam_t, vfov, pitch,
                                               roll))
    phase_card_vs_cpu()
    phase_pipeline_card_vs_cpu()
    phase_graphs()
    phase_lbs_backward()
    phase_cli_devices()
    serve_launches = phase_serve()
    eval_launches = phase_eval()
    train_launches = phase_train()
    phase_camcalib_train()
    smplify = phase_smplify()
    phase_remat()
    render = phase_render(build_seconds)
    exported = phase_export()
    synth_launches = phase_datagen()
    parallel = phase_parallel()

    row = lbs_rows[main_batch]         # K1's batch on this slice's path

    def k3_entry(tag):
        """K3 in ``tag`` (bf16, or fp32 as 3xTF32): layer1's block at
        B = 16, launches in one fused-pipeline call of that dtype."""
        k3 = k3_rows[tag, 0]
        return {
            'name': 'fused_bottleneck_chain'
                    + (' (fp32, 3xTF32)' if tag == 'fp32' else ''),
            'route': 'cuda',
            'source': 'spec_tpu_torch/csrc/bottleneck.cu',
            'replaces': 'spec_tpu/ops/pallas/bottleneck.py:92',
            'launches': pipe[tag]['fused']['launches']['K3'],
            'max_abs_err': max(r['max_abs_err']
                               for (t, _), r in k3_rows.items() if t == tag),
            'ms': k3['ms'],
            'wrapper_ms': k3['wrapper_ms'],
            'plain_ms': k3['plain_ms'],
            'bound_ms': k3['bound_ms'],
            'bound_by': k3['bound_by'],
            'share_of_bound': k3['bound_ms'] / k3['ms'],
            'library_ms': k3['cudnn_ms'],   # the cuDNN Bottleneck module
        }
    print(json.dumps({'kernels': [{
        'name': 'fused_lbs_vertices',
        'route': 'cuda',
        'source': 'spec_tpu_torch/csrc/lbs.cu',
        'replaces': 'spec_tpu/ops/pallas/lbs.py:97',
        # this slice's path: one predict call at phase 4's input (fp32)
        # of the artifact exported on the CPU and loaded on the card;
        # the times below are phase 6's at that path's stage-2 batch
        'launches': exported['fp32 cpu-exported'],
        'batch': main_batch,
        'launches_by_path': {**render,
                             # phase 23: the data-parallel paths
                             **parallel,
                             # this slice's paths: one predict of the
                             # artifact exported on the CPU, loaded on
                             # the card (fp32), and spec_synth
                             'exported predict':
                                 exported['fp32 cpu-exported'],
                             **{f'exported predict ({k})': v
                                for k, v in exported.items()},
                             'spec_synth': synth_launches,
                             'detector predict': det['launches'],
                             'hrnet predict': hrnet['predict_launches'],
                             'hrnet train': hrnet['train_launches'],
                             'train': train_launches,
                             'serve window': serve_launches,
                             'eval step replay': eval_launches,
                             'smplify fit': smplify['launches']},
        'max_abs_err': max(r['max_abs_err'] for r in lbs_rows.values()),
        'ms': row['ms'],
        'wrapper_ms': row['wrapper_ms'],
        'plain_ms': row['plain_ms'],
        'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'],
        # the closed-form backward at the train step's batch: measured
        # alone in the SMPLify phase, bound from its code
        # (_k1_backward_work)
        'backward_batch': TRAIN_BATCH,
        'backward_ms': smplify['k1_bwd_ms'],
        'backward_bound_ms': _bound(*_k1_backward_work(TRAIN_BATCH),
                                    PEAK_FLOPS['fp32'])[0],
        # phase 6's kernel time at the batch each listed path gives K1
        'ms_by_path': {'exported predict': row['ms'],
                       'spec_synth': lbs_rows[SYNTH['n']]['ms'],
                       'parallel train rank': lbs_rows[PAR_BATCH // 2]['ms'],
                       'data_parallel predict (2 replicas)':
                           lbs_rows[main_batch // 2]['ms']},
        'library_ms': None,        # no single PyTorch call computes it
    }, k3_entry('bf16'), k3_entry('fp32'), {
        'name': 'project_points',
        'route': 'cuda',
        'source': 'spec_tpu_torch/csrc/projection.cu',
        'replaces': 'spec_tpu/ops/pallas/projection.py:39',
        'launches': k2['launches'],
        'max_abs_err': k2['max_abs_err'],
        'ms': k2['ms'],
        'wrapper_ms': k2['wrapper_ms'],
        'plain_ms': k2['plain_ms'],
        'bound_ms': k2['bound_ms'],
        'bound_by': k2['bound_by'],
        'library_ms': None,        # no single PyTorch call computes it
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
