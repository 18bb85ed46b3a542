"""The train steps' CUDA graphs on a card (``train/steps.TrainStep``, a
``utils/graphs.StageGraph`` over the step body):
replay against the eager body from one state, K1's launches per replay,
fresh dropout masks on every replay from a registered generator, the
accumulating and updating graphs of GRAD_ACCUM_STEPS = 2, the CamCalib
step with the on-device jitter, and a capture that fails.

Marked ``cuda``; skips without a GPU (a CUDA graph has no CPU mode). It
imports no JAX:

    python -m pytest tests/test_torch_cuda_train.py -m cuda --noconftest

Small models (ResNet-18, 64² crops, V = 6890 synthetic SMPL): what is
checked is the capture and the replay. Replay and eager run the same
kernels; with cuDNN deterministic they agree within the limits of
chip_smoke.py's train phase (losses 1e-6 relative, the model 1e-4
relative after a step; both usually exact).
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.models.hmr import HMR
from spec_tpu_torch.ops import lbs as L
from spec_tpu_torch.train import (
    adam,
    create_train_state,
    make_camcalib_train_step,
    make_spec_train_step,
)
from spec_tpu_torch.train.state import Transform

LOSS_RTOL, MODEL_RTOL = 1e-6, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _batch(B, res, device, seed=0):
    rng = np.random.RandomState(seed)
    K = np.tile(np.array([[1500., 0., 960.], [0., 1500., 540.],
                          [0., 0., 1.]], 'f4'), (B, 1, 1))
    arrays = {
        'img': rng.randn(B, res, res, 3).astype('f4'),
        'pose': (rng.randn(B, 72) * 0.2).astype('f4'),
        'betas': (rng.randn(B, 10) * 0.3).astype('f4'),
        'pose_conf': np.ones((B, 24), 'f4'),
        'pose_3d': rng.randn(B, 24, 4).astype('f4'),
        'keypoints_orig': np.concatenate(
            [rng.rand(B, 49, 2) * 1000, np.ones((B, 49, 1))],
            -1).astype('f4'),
        'has_smpl': np.ones(B, 'f4'), 'has_pose_3d': np.ones(B, 'f4'),
        'orig_shape': np.tile(np.array([[1080., 1920.]], 'f4'), (B, 1)),
        'scale': (rng.rand(B) + 1).astype('f4'),
        'center': (rng.rand(B, 2) * 800 + 300).astype('f4'),
        'cam_rotmat': np.tile(np.eye(3, dtype='f4'), (B, 1, 1)),
        'cam_intrinsics': K,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _spec(device, tx=None, dropout=0.5, dtype=torch.float32):
    model = HMR(backbone='resnet18', use_cam_feats=True, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.head.dropout_rate = dropout
    model = model.to(device)
    state = create_train_state(model, tx or adam(1e-4))
    return state, make_spec_train_step(model, S.create_test_assets())


def _rel(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum())
              for k in b if not k.endswith('num_batches_tracked'))
    den = sum(float((b[k].double() ** 2).sum())
              for k in b if not k.endswith('num_batches_tracked'))
    return (num / den) ** 0.5


def _clone(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.optimizer.state_dict(), state.step)


def _restore(state, snap):
    state.model.load_state_dict(snap[0])
    state.optimizer.load_state_dict(snap[1])
    state.step = snap[2]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_replay_matches_eager_and_launches_k1_twice(cuda_device, dtype,
                                                    monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    state, step = _spec(cuda_device, dropout=0.0, dtype=dtype)
    batch = _batch(4, 64, cuda_device)
    step(state, batch)                          # eager first call, capture
    snap = _clone(state)
    _, eager = step.eager(state, batch)
    after_eager = {k: v.clone() for k, v in state.model.state_dict().items()}
    _restore(state, snap)
    before = L.LAUNCHES
    _, replay = step(state, batch)
    assert L.LAUNCHES - before == 2             # GT and predicted mesh
    for k in eager:
        torch.testing.assert_close(replay[k], eager[k], rtol=LOSS_RTOL,
                                   atol=0)
    assert _rel(state.model.state_dict(), after_eager) <= MODEL_RTOL
    assert len(step.graphs.signatures()) == 1 and state.step == 2


@pytest.mark.cuda
def test_replays_draw_new_dropout_masks(cuda_device):
    """With a registered generator each replay drops other features: the
    same state and batch give another loss on each replay, and a fresh
    run from the same seed repeats the sequence."""
    runs = []
    for _ in range(2):
        state, step = _spec(cuda_device, tx=adam(0.0))
        batch = _batch(4, 64, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        runs.append([float(step(state, batch, gen)[1]['loss/total_loss'])
                     for _ in range(4)])
    assert runs[0] == runs[1]
    assert len(set(runs[0][1:])) == 3           # the replays differ


@pytest.mark.cuda
def test_accumulation_graphs_match_eager(cuda_device, monkeypatch):
    """GRAD_ACCUM_STEPS = 2: an accumulating and an updating graph; four
    micro-steps by replay equal four by the eager body."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    tx = Transform('adam', 1e-4, clip_norm=1.0, every_k=2)
    state, step = _spec(cuda_device, tx=tx, dropout=0.0)
    batches = [_batch(4, 64, cuda_device, seed=s) for s in range(2)]
    for b in batches:                           # capture both graphs
        step(state, b)
    snap = _clone(state)
    for b in batches * 2:
        step.eager(state, b)
    eager = {k: v.clone() for k, v in state.model.state_dict().items()}
    count = float(state.optimizer.count)
    _restore(state, snap)
    for b in batches * 2:
        step(state, b)
    assert len(step.graphs.signatures()) == 2
    assert float(state.optimizer.count) == count == 3.0
    assert _rel(state.model.state_dict(), eager) <= MODEL_RTOL


@pytest.mark.cuda
def test_camcalib_step_with_device_jitter(cuda_device):
    rng = np.random.RandomState(5)
    model = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(cuda_device), adam(1e-4))
    step = make_camcalib_train_step(model)
    B, H, W = 4, 64, 96
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in {
        'img': rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        'vfov': rng.uniform(-1, 1, B).astype('f4'),
        'pitch': rng.uniform(-1, 1, B).astype('f4'),
        'roll': rng.uniform(-1, 1, B).astype('f4'),
        'jitter_A': np.tile(np.eye(3, dtype='f4'), (B, 1, 1)),
        'jitter_b': np.zeros((B, 3), 'f4'),
        'true_shape': np.array([[H, W]] * B, np.int32)}.items()}
    losses = [float(step(state, batch)[1]['loss']) for _ in range(4)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert len(step.graphs.signatures()) == 1


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device):
    state, step = _spec(cuda_device)
    batch = _batch(2, 64, cuda_device)
    calls = []
    loss_fn = step.loss_fn

    def syncing(model, generator, b):
        if calls:                               # the capture's run
            float(b['img'].sum())               # a host read: refused
        calls.append(1)
        return loss_fn(model, generator, b)

    step.loss_fn = syncing
    with pytest.raises(RuntimeError, match="CUDA graph capture of stage "
                                           "'spec_train_step'"):
        step(state, batch)
