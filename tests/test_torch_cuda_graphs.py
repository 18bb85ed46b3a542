"""CUDA graph replays of the port's stages against their eager bodies, on a
card: the predictor's two stages (fp32 and bf16), both pipelines, chunks
of one padded shape in one call, the LRU cap, a capture that fails and
the kernels' launch counters.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_graphs.py -m cuda --noconftest

Small models (ResNet-18 predictor, ResNet-50 pipelines on 64x96 frames):
what is checked is the capture and the replay, not the width. Replays
run the same kernels as the eager body on the same inputs, so they are
held to it within chip_smoke.py's card-vs-CPU limits (they usually agree
bit for bit; chip_smoke.py prints which).
"""

import gc
import os
import pathlib
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from spec_tpu_torch.ops import bottleneck as TB
from spec_tpu_torch.ops import lbs as L
from spec_tpu_torch.utils import graphs

REPO = pathlib.Path(__file__).resolve().parents[1]
# chip_smoke.py's card-vs-CPU limits, per predictor output (fp32); bf16
# takes its pipelines' bf16 limits (vertices 1e-2 m, joints2d 0.5 px).
PREDICT_LIMITS = {
    'fp32': dict(pred_pose=2e-3, pred_pose_6d=2e-3, pred_shape=2e-3,
                 pred_cam=2e-3, pred_cam_t=2e-3, smpl_vertices=5e-3,
                 smpl_joints3d=5e-3, smpl_joints2d=0.1),
    'bf16': dict(pred_pose=1e-2, pred_pose_6d=1e-2, pred_shape=1e-2,
                 pred_cam=1e-2, pred_cam_t=1e-2, smpl_vertices=1e-2,
                 smpl_joints3d=1e-2, smpl_joints2d=0.5),
}
ANGLE_LIMIT = {'fp32': 1e-4, 'bf16': 1e-3}
# (vertices m, joints2d px, cam_t, vfov, pitch, roll rad), chip_smoke.py.
PIPELINE_LIMITS = {'fp32': (5e-3, 0.1, 2e-3, 1e-4, 1e-4, 1e-4),
                   'bf16': (1e-2, 0.5, 1e-2, 1e-3, 1e-3, 1e-3)}
DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _predictor(dtype, batch_size=8):
    from spec_tpu_torch.serving import SpecPredictor

    return SpecPredictor(device='cuda', backbone='resnet18',
                         camcalib_backbone='resnet18', use_cam_feats=True,
                         min_size=96, img_res=64, batch_size=batch_size,
                         dtype=DTYPES[dtype])


def eager_predict(pred, *args, **kwargs):
    """``pred.predict`` with both stages run by their eager bodies."""
    stages = pred._stage1, pred._stage2
    pred._stage1, pred._stage2 = stages[0].fn, stages[1].fn
    try:
        return pred.predict(*args, **kwargs)
    finally:
        pred._stage1, pred._stage2 = stages


def _frames(persons, seed=11):
    rng = np.random.RandomState(seed)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)
              for _ in persons]
    boxes = [np.stack([[rng.uniform(30, 100), rng.uniform(30, 70),
                        rng.uniform(30, 50), rng.uniform(40, 70)]
                       for _ in range(k)]).astype(np.float32)
             if k else np.zeros((0, 4), np.float32) for k in persons]
    return frames, boxes


def _hold(got, want, dtype):
    """Per-person outputs and cameras of two predict calls agree."""
    (res_g, cams_g), (res_e, cams_e) = got, want
    for cg, ce in zip(cams_g, cams_e):
        for k in ('vfov', 'pitch', 'roll'):
            assert abs(cg[k] - ce[k]) <= ANGLE_LIMIT[dtype], k
    assert [len(r) for r in res_g] == [len(r) for r in res_e]
    for rg, re in zip(res_g, res_e):
        for pg, pe in zip(rg, re):
            for k, lim in PREDICT_LIMITS[dtype].items():
                assert np.isfinite(pg[k]).all(), k
                assert np.abs(pg[k] - pe[k]).max() <= lim, k


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_predictor_replays_match_eager(cuda_device, dtype):
    pred = _predictor(dtype)
    frames, boxes = _frames((0, 1, 3))
    first = pred.predict(frames, boxes, return_cameras=True)    # capture
    again = pred.predict(frames, boxes, return_cameras=True)    # replay
    eager = eager_predict(pred, frames, boxes, return_cameras=True)
    assert len(pred._stage1.signatures()) == 1
    assert len(pred._stage2.signatures()) == 1
    _hold(first, eager, dtype)
    _hold(again, eager, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('persons,chunks', [((3, 3, 2), 1), ((3, 2, 1), 2)])
def test_same_shape_chunks_in_one_call_come_back_distinct(
        cuda_device, persons, chunks):
    """batch_size 4: 8 persons are two chunks of the same padded shape
    (one graph replayed twice in one call), 6 are 4 + 2 (two graphs).
    A first call captures; the second replays."""
    pred = _predictor('fp32', batch_size=4)
    frames, boxes = _frames(persons, seed=5)
    pred.predict(frames, boxes)
    got = pred.predict(frames, boxes, return_cameras=True)
    assert len(pred._stage2.signatures()) == chunks
    _hold(got, eager_predict(pred, frames, boxes, return_cameras=True),
          'fp32')
    people = [p for r in got[0] for p in r]
    first, last = people[0]['smpl_vertices'], people[-1]['smpl_vertices']
    assert not np.array_equal(first, last)


@pytest.mark.cuda
def test_camcalib_every_stream_replays_match_eager(cuda_device):
    pred = _predictor('fp32')
    pred.camcalib_every, pred.cut_threshold = 3, 0.0
    frames, boxes = _frames((1, 1, 1, 1, 1))
    pred.predict(frames, boxes, stream='capture')
    got = pred.predict(frames, boxes, stream='g', return_cameras=True)
    want = eager_predict(pred, frames, boxes, stream='e',
                         return_cameras=True)
    _hold(got, want, 'fp32')
    cams = got[1]
    assert cams[1] == cams[0] and cams[3] != cams[0]


def _pipeline(stage1, dtype):
    from spec_tpu_torch.ops.preprocess import spin_crop_corners
    from spec_tpu_torch.pipeline import build_pipeline

    rng = np.random.RandomState(1)
    raw = (rng.rand(2, 64, 96, 3) * 255).astype('f4')
    center = ((rng.rand(2, 2) * [0.45, 0.6] + [0.27, 0.2])
              * [96, 64]).astype('f4')
    scale = ((rng.rand(2) * 0.8 + 0.8) * 64 / 512).astype('f4')
    corners = spin_crop_corners(center, scale)
    args = tuple(torch.from_numpy(a).cuda()
                 for a in (raw, corners, center, scale))
    *_, pipeline = build_pipeline(compute_dtype=DTYPES[dtype], img_res=64,
                                  stage1=stage1, device='cuda')
    return pipeline, args


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('stage1', ['module', 'fused'])
def test_pipeline_replays_match_eager(cuda_device, stage1, dtype):
    pipeline, args = _pipeline(stage1, dtype)
    with torch.inference_mode():
        eager = pipeline.fn(*args)
    for _ in range(2):                      # capture, then a replay
        got = pipeline(*args)
        for g, e, lim in zip(got, eager, PIPELINE_LIMITS[dtype]):
            assert g.shape == e.shape and bool(torch.isfinite(g).all())
            assert (g - e).abs().max().item() <= lim
    assert len(pipeline.signatures()) == 1


@pytest.mark.cuda
def test_launch_counters_count_replays(cuda_device):
    """The first call runs eagerly (real launches, its output returned)
    and captures (none); every later call is one replay, counted as the
    eager body counts its launches."""
    pipeline, args = _pipeline('fused', 'bf16')
    with torch.inference_mode():
        TB.LAUNCHES = L.LAUNCHES = 0
        pipeline.fn(*args)
        k3, k1 = TB.LAUNCHES, L.LAUNCHES
        assert k3 > 0 and k1 == 1
        TB.LAUNCHES = L.LAUNCHES = 0
        pipeline(*args)
        assert (TB.LAUNCHES, L.LAUNCHES) == (k3, k1)
        TB.LAUNCHES = L.LAUNCHES = 0
        pipeline(*args)
        pipeline(*args)
        torch.cuda.synchronize()
        assert (TB.LAUNCHES, L.LAUNCHES) == (2 * k3, 2 * k1)


PROFILED_REPLAY = '''
import numpy as np
import torch
from spec_tpu_torch.bench import device_profile
from spec_tpu_torch.ops import bottleneck as TB
from spec_tpu_torch.ops.preprocess import spin_crop_corners
from spec_tpu_torch.pipeline import build_pipeline

rng = np.random.RandomState(1)
center = np.array([[48.0, 32.0], [40.0, 30.0]], 'f4')
scale = np.array([0.3, 0.25], 'f4')
args = tuple(torch.from_numpy(a).cuda() for a in (
    (rng.rand(2, 64, 96, 3) * 255).astype('f4'),
    spin_crop_corners(center, scale), center, scale))
*_, pipeline = build_pipeline(compute_dtype=torch.bfloat16, img_res=64,
                              stage1='fused', device='cuda')
with torch.inference_mode():
    pipeline.fn(*args)
    k3 = TB.LAUNCHES
    pipeline(*args)
    prof = device_profile(lambda: pipeline(*args), n_calls=2)
count = {k: sum(n for op, n in prof['count_by_name'].items() if k in op)
         for k in ('bottleneck_tc_kernel', 'lbs_kernel')}
assert count == {'bottleneck_tc_kernel': k3, 'lbs_kernel': 1}, (count, k3)
assert prof['host_launches'] < prof['device_ops'] / 4, prof
print('replay ran', count)
'''


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, cwd=str(REPO), env=env)


@pytest.mark.cuda
def test_replays_run_the_hand_kernels(cuda_device):
    """The profiler sees K3 and K1 by name inside a replay, as many times
    as the eager body launches them, from a few host launch calls. In a
    process of its own: a CPU and CUDA profile leaves later CUDA-only
    profiles in the same process empty (tests/test_torch_cuda_projection
    .py takes one)."""
    proc = _run(PROFILED_REPLAY)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'replay ran' in proc.stdout


@pytest.mark.cuda
def test_lru_cap_frees_evicted_graphs(cuda_device):
    cap, n_sigs = graphs.MAX_GRAPHS, graphs.MAX_GRAPHS + 3
    stage = graphs.StageGraph('double', lambda x: x * 2.0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    refs = []
    for n in range(1, n_sigs + 1):
        x = torch.full((n, 1 << 16), float(n), device='cuda')
        out = stage(x)
        assert torch.equal(out, x * 2.0)
        refs.append(weakref.ref(stage._graphs[stage.signatures()[-1]]))
        del x, out
    gc.collect()
    assert [s[0][0][0] for s in stage.signatures()] == list(
        range(n_sigs - cap + 1, n_sigs + 1))
    assert [r() is None for r in refs] == [n <= n_sigs - cap
                                           for n in range(1, n_sigs + 1)]
    # Only the kept graphs' static inputs and outputs stay allocated,
    # counted as the allocator's blocks that hold them: a block can be up
    # to 1 MiB larger than its tensor (the allocator does not split off
    # a smaller remainder of a cached block), so after other tests have
    # left cached blocks behind, the tensors' own sizes undercount.
    ptrs = {t.data_ptr() for key in stage.signatures()
            for t in stage._graphs[key].inputs + stage._graphs[key].outputs}
    blocks = [b['size'] for seg in torch.cuda.memory._snapshot()['segments']
              for b in seg['blocks']
              if b['state'] == 'active_allocated' and b['address'] in ptrs]
    assert len(ptrs) == len(blocks) == 2 * cap
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - base <= sum(blocks) + (1 << 20)


FAILING_CAPTURE = '''
import torch
from spec_tpu_torch.utils.graphs import StageGraph
calls = []
def bad(x):
    calls.append(1)
    return x * float(x.sum())      # a host read: refused in a capture
stage = StageGraph('bad', bad)
try:
    stage(torch.ones(4, device='cuda'))
except RuntimeError as e:
    assert "stage 'bad'" in str(e) and '(4,) float32 cuda:0' in str(e), e
    assert stage.signatures() == []
    print('raised after', len(calls), 'runs')
else:
    raise SystemExit('the failed capture returned a result')
'''


@pytest.mark.cuda
def test_failed_capture_raises_and_falls_back_to_nothing(cuda_device):
    """In a process of its own, so the failed capture touches no other
    test: the warm-up runs, the capture raises naming the stage and the
    signature, and no result comes back."""
    proc = _run(FAILING_CAPTURE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'raised after 2 runs' in proc.stdout


def _eval_inputs(B, res, seed=21):
    rng = np.random.RandomState(seed)
    K = np.tile(np.array([[300., 0., 80.], [0., 300., 60.], [0., 0., 1.]],
                         'f4'), (B, 1, 1))
    batch = {
        'img': rng.rand(B, res, res, 3).astype('f4'),
        'pose': (rng.randn(B, 72) * 0.2).astype('f4'),
        'betas': (rng.randn(B, 10) * 0.5).astype('f4'),
        'gender': (np.arange(B) % 2).astype(np.int32),
        'scale': (rng.rand(B) * 0.3 + 0.5).astype('f4'),
        'center': (rng.rand(B, 2) * 40 + 60).astype('f4'),
        'orig_shape': np.tile(np.array([[120., 160.]], 'f4'), (B, 1)),
        'cam_rotmat': np.tile(np.eye(3, dtype='f4'), (B, 1, 1)),
        'cam_intrinsics': K,
    }
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_eval_step_replays_match_eager_bit_for_bit(cuda_device, dtype):
    """The eval step (ResNet-18, gendered GT, B = 8, 64^2 crops): its
    graph replays give the eager step's bits, and each replay launches K1
    four times (the model's SMPL, GT male and female, the predicted
    native joints)."""
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.eval.eval_loop import make_eval_step
    from spec_tpu_torch.models.hmr import HMR

    assets = {g: S.create_test_assets(seed=i)
              for i, g in enumerate(('neutral', 'male', 'female'))}
    model = HMR(backbone='resnet18', use_cam_feats=True, img_res=64,
                dtype=DTYPES[dtype])
    model.reset_parameters(torch.Generator().manual_seed(0))
    step = make_eval_step(model.cuda(), assets,
                          assets['neutral'].j_regressor_h36m.numpy(),
                          use_gender=True)
    batch = _eval_inputs(8, 64)
    eager = step.eager(batch)
    step(batch)                                     # capture
    L.LAUNCHES = 0
    got = step(batch)                               # one replay
    torch.cuda.synchronize()
    assert L.LAUNCHES == 4
    assert len(step.head.signatures()) == 1
    assert pytree.tree_structure(got) == pytree.tree_structure(eager)
    for i, (g, e) in enumerate(zip(pytree.tree_leaves(got),
                                   pytree.tree_leaves(eager))):
        assert bool(torch.isfinite(g).all()), i
        assert torch.equal(g, e), i


@pytest.mark.cuda
def test_compute_error_on_card_matches_cpu(cuda_device):
    """compute_error's chunk graphs (K1 twice a chunk) against the same
    call on the CPU, j14 and j24, 300 samples: within 0.05 mm."""
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.eval.evaluator import compute_error

    rng = np.random.RandomState(4)
    N, V = 300, 6890
    assets = S.create_test_assets()
    jreg = assets.j_regressor_h36m.numpy()
    kw = dict(pred_vertices=(rng.randn(N, V, 3) * 0.3).astype('f4'),
              pred_cam_rotmat=np.tile(np.eye(3, dtype='f4'), (N, 1, 1)),
              gt_pose=(rng.randn(N, 72) * 0.2).astype('f4'),
              gt_betas=(rng.randn(N, 10) * 0.5).astype('f4'),
              gt_pose_cam=(rng.randn(N, 72) * 0.2).astype('f4'),
              assets=assets, j_regressor_h36m=jreg)
    for ds in ('3dpw-test-cam', 'spec-mtp'):
        L.LAUNCHES = 0
        card = compute_error(ds, device='cuda', **kw)
        assert L.LAUNCHES == 2 + 2          # the first call's, a replay
        cpu = compute_error(ds, device='cpu', **kw)
        for k in cpu:
            if k != 'protocol':
                assert abs(card[k] - cpu[k]) <= 0.05, (ds, k)


@pytest.mark.cuda
def test_device_prefetch_copies_on_a_side_stream(cuda_device):
    """device_prefetch on the card: every batch arrives whole on the
    current stream, though its copy was queued on a side stream while
    the batch before it was in use."""
    from spec_tpu_torch.data.loader import device_prefetch

    rng = np.random.RandomState(5)
    batches = [{'x': rng.rand(64, 224, 224, 3).astype('f4'), 'n': i}
               for i in range(4)]
    seen = []
    for b in device_prefetch(iter(batches), 'cuda', tensor_keys=('x',)):
        assert b['x'].is_cuda
        seen.append((b['n'], (b['x'] * 2).sum().item()))
    assert [n for n, _ in seen] == [0, 1, 2, 3]
    for n, total in seen:
        want = float((batches[n]['x'].astype('f8') * 2).sum())
        assert abs(total - want) <= 1e-4 * abs(want)
