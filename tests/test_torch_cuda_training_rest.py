"""The rest of training on a card: the SMPLify fit as one CUDA graph, the
CamCalib train step's replays, and REMAT inside the SPEC step's graph.

Marked ``cuda``; skips without a GPU (a CUDA graph has no CPU mode). It
imports no JAX:

    python -m pytest tests/test_torch_cuda_training_rest.py -m cuda \\
        --noconftest

Small sizes (B = 8 fits of 5 iterations on V = 6890 synthetic SMPL;
ResNet-18 at 64x96 frames or 64² crops): what is checked is the capture
and the replay, each held to its eager body bit for bit (the same
kernels on the same inputs; cuDNN deterministic where convolutions run),
and K1's launches per fit replay (one per SMPL forward).
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
from spec_tpu_torch.train import smplify as TF


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _problem(B, device, seed=0):
    rng = np.random.RandomState(seed)
    K = np.tile(np.array([[1000.0, 0, 500], [0, 1000.0, 500], [0, 0, 1]],
                         'f4'), (B, 1, 1))
    kp = np.concatenate([rng.rand(B, 49, 2) * 200 + 400,
                         np.ones((B, 49, 1))], -1).astype('f4')
    arrays = [(rng.randn(B, 1, 3) * 0.2).astype('f4'),
              (rng.randn(B, 23, 3) * 0.2).astype('f4'),
              np.zeros((B, 10), 'f4'),
              np.tile(np.array([[0.0, 0.0, 5.0]], 'f4'), (B, 1)),
              kp, np.tile(np.eye(3, dtype='f4'), (B, 1, 1)), K]
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
def test_smplify_replay_matches_eager_and_launches_k1(cuda_device):
    assets = S.fused_on(S.create_test_assets(), cuda_device)
    args = _problem(8, cuda_device)
    first = TF.smplify_fit(assets, *args, num_iters=5)   # eager, capture
    eager = TF.smplify_fit(assets, *args, num_iters=5, eager=True)
    before = L.LAUNCHES
    replay = TF.smplify_fit(assets, *args, num_iters=5)
    assert L.LAUNCHES - before == 6                      # 5 + final
    for a, b, c in zip(replay, eager, first):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert len(TF._fit_graph(assets).signatures()) == 1
    # new inputs through the same graph
    other = TF.smplify_fit(assets, *_problem(8, cuda_device, seed=1),
                           num_iters=5)
    assert not torch.equal(other.body_pose, replay.body_pose)


@pytest.mark.cuda
def test_smplify_trainer_hook_runs_graphs(cuda_device):
    """The hook's prediction and fit both replay graphs on the card."""
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils.config import spec_default_config

    cfg = spec_default_config()
    cfg.LOGDIR = ''
    cfg.TRAINING.RUN_SMPLIFY = True
    cfg.TRAINING.NUM_SMPLIFY_ITERS = 3
    cfg.TRAINING.SMPLIFY_THRESHOLD = 1e9
    assets = S.create_test_assets()
    model = HMR(backbone='resnet18', use_cam_feats=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = SpecTrainer(cfg, model.to(cuda_device).train(),
                          {'neutral': assets},
                          assets.j_regressor_h36m.numpy(), lambda e: None,
                          lambda: {})
    B = 4
    rng = np.random.RandomState(2)
    dev = {k: torch.from_numpy(v).to(cuda_device) for k, v in {
        'img': rng.randn(B, 64, 64, 3).astype('f4'),
        'pose': np.zeros((B, 72), 'f4'), 'betas': np.zeros((B, 10), 'f4'),
        'has_smpl': np.zeros(B, 'f4'),
        'keypoints_orig': np.concatenate(
            [rng.rand(B, 49, 2) * 400, np.ones((B, 49, 1))],
            -1).astype('f4'),
        'orig_shape': np.tile(np.array([[480.0, 640.0]], 'f4'), (B, 1)),
        'scale': (rng.rand(B) + 1).astype('f4'),
        'center': (rng.rand(B, 2) * 200 + 100).astype('f4'),
        'cam_rotmat': np.tile(np.eye(3, dtype='f4'), (B, 1, 1)),
        'cam_intrinsics': np.tile(np.array(
            [[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]], 'f4'),
            (B, 1, 1))}.items()}
    outs = [trainer._run_smplify(dev) for _ in range(2)]
    for k in ('pose', 'betas', 'has_smpl'):
        assert outs[0][k].device.type == 'cuda'
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert float(outs[0]['has_smpl'].min()) == 1.0
    assert len(trainer._predict.signatures()) == 1
    assert trainer.model.training


@pytest.mark.cuda
@pytest.mark.parametrize('jitter', [False, True])
def test_camcalib_replay_matches_eager(cuda_device, jitter, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    rng = np.random.RandomState(3)
    model = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(cuda_device), adam(1e-3))
    step = make_camcalib_train_step(
        model, loss_type='softargmax_biased_l2', vfov_loss_weight=10.0,
        pitch_loss_weight=10.0, roll_loss_weight=10.0)
    B, H, W = 4, 64, 96
    arrays = {'vfov': rng.uniform(-1, 1, B).astype('f4'),
              'pitch': rng.uniform(-1, 1, B).astype('f4'),
              'roll': rng.uniform(-1, 1, B).astype('f4')}
    if jitter:
        arrays.update(
            img=rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
            jitter_A=np.tile(np.eye(3, dtype='f4') * 1.1, (B, 1, 1)),
            jitter_b=np.full((B, 3), 5.0, 'f4'),
            true_shape=np.array([[H, W], [H - 8, W], [H, W - 16], [H, W]],
                                np.int32))
    else:
        arrays['img'] = rng.randn(B, H, W, 3).astype('f4')
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in arrays.items()}
    step(state, batch)                             # eager first call, capture
    snap = ({k: v.clone() for k, v in model.state_dict().items()},
            state.optimizer.state_dict(), state.step)
    _, eager = step.eager(state, batch)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(snap[0])
    state.optimizer.load_state_dict(snap[1])
    state.step = snap[2]
    _, replay = step(state, batch)
    for k in eager:
        assert torch.equal(replay[k], eager[k]), k
    for k, v in model.state_dict().items():
        assert torch.equal(v, after[k]), k


@pytest.mark.cuda
def test_remat_step_replays_as_the_plain_step(cuda_device, monkeypatch):
    """The SPEC step with ``remat`` captured in a graph: its replay gives
    the plain model's losses, parameters and BN statistics."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    from spec_tpu_torch.bench import train_inputs

    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in train_inputs(4, 64).items()}
    runs = []
    for remat in (False, True):
        model = HMR(backbone='resnet18', use_cam_feats=True, remat=remat)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.head.dropout_rate = 0.0
        model = model.to(cuda_device)
        state = create_train_state(model, adam(1e-4))
        step = make_spec_train_step(model, S.create_test_assets())
        step(state, batch)
        _, losses = step(state, batch)               # a replay
        runs.append((losses, {k: v.clone()
                              for k, v in model.state_dict().items()}))
    (l0, s0), (l1, s1) = runs
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
