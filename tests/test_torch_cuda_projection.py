"""The projection CUDA kernel against its plain PyTorch version and
``geometry.perspective_projection``, on a card.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_projection.py -m cuda --noconftest

Budget 0.01 px, the JAX package's chip check (TPU_CHECKS_r05.json).
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch.core import geometry as G
from spec_tpu_torch.ops import projection as TP

BUDGET = 1e-2   # px


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


def _inputs(B, V, seed, device):
    rng = np.random.RandomState(seed)
    pts = rng.randn(B, V, 3).astype('f4') + np.array([0, 0, 5], 'f4')
    R = G.euler_to_rotmat(torch.from_numpy(
        rng.randn(B, 3).astype('f4') * 0.2))
    t = torch.from_numpy(rng.randn(B, 3).astype('f4') * 0.5)
    K = G.build_cam_intrinsics(torch.full((B,), 1500.0),
                               torch.full((B,), 1920.0),
                               torch.full((B,), 1080.0))
    return [a.to(device) for a in (torch.from_numpy(pts), R, t, K)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,V', [(1, 49), (16, 6890), (5, 333), (80, 130)])
def test_kernel_matches_plain(cuda_device, B, V):
    args = _inputs(B, V, seed=B, device=cuda_device)
    before = TP.LAUNCHES
    out = TP.project_points(*args)
    torch.cuda.synchronize()
    assert TP.LAUNCHES == before + 1
    assert out.shape == (B, V, 2)
    for ref in (TP.project_points_plain(*args),
                G.perspective_projection(*args)):
        assert (out - ref).abs().max().item() <= BUDGET


@pytest.mark.cuda
def test_kernel_on_card_matches_cpu(cuda_device):
    args = _inputs(4, 500, seed=0, device=cuda_device)
    out = TP.project_points(*args).cpu()
    ref = TP.project_points(*(a.cpu() for a in args))
    assert (out - ref).abs().max().item() <= BUDGET


@pytest.mark.cuda
@pytest.mark.parametrize('case,err', [('device', ValueError),
                                      ('dtype', TypeError),
                                      ('layout', ValueError)])
def test_refused_operands_raise_before_launch(cuda_device, case, err):
    pts, R, t, K = _inputs(2, 10, seed=0, device=cuda_device)
    if case == 'device':
        K = K.cpu()
    elif case == 'dtype':
        pts = pts.half()
    elif case == 'layout':
        pts = pts.transpose(0, 1)
    before = TP.LAUNCHES
    with pytest.raises(err):
        TP.project_points(pts, R, t, K)
    assert TP.LAUNCHES == before
