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
@pytest.mark.parametrize('B,V', [(1, 49), (16, 6890), (5, 333), (80, 130),
                                 (1, 1), (3, 7), (40, 1), (7, 5), (2, 1023)])
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


def _variant(a, case):
    """``a`` as float64, or as a non-contiguous float32 view of the same
    values."""
    if case == 'float64':
        return a.double()
    wide = torch.zeros(a.shape + (2,), dtype=a.dtype, device=a.device)
    wide[..., 0] = a
    return wide[..., 0]


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['float64', 'strided'])
@pytest.mark.parametrize('which', [1, 2, 3])
def test_cameras_of_any_float_type_and_layout(cuda_device, case, which):
    """R, t or K not float32 or not contiguous: the wrapper casts or
    copies it, and the result is the plain version's."""
    args = _inputs(3, 500, seed=which, device=cuda_device)
    args[which] = _variant(args[which], case)
    assert args[which].dtype != torch.float32 or \
        not args[which].is_contiguous()
    before = TP.LAUNCHES
    out = TP.project_points(*args)
    torch.cuda.synchronize()
    assert TP.LAUNCHES == before + 1
    assert (out - TP.project_points_plain(*args)).abs().max().item() <= BUDGET


@pytest.mark.cuda
def test_unaligned_points(cuda_device):
    """Points 4 bytes off a 16-byte boundary take the word-by-word path."""
    pts, R, t, K = _inputs(3, 7, seed=2, device=cuda_device)
    flat = torch.empty(pts.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(pts.shape)
    shifted.copy_(pts)
    out = TP.project_points(shifted, R, t, K)
    ref = TP.project_points_plain(pts, R, t, K)
    assert (out - ref).abs().max().item() <= BUDGET


@pytest.mark.cuda
def test_one_device_operation_per_call(cuda_device):
    """On float32 contiguous operands a call is the kernel alone: the
    camera collapses inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = _inputs(16, 6890, seed=3, device=cuda_device)
    TP.project_points(*args)
    torch.cuda.synchronize()
    before = TP.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            TP.project_points(*args)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert TP.LAUNCHES == before + 3
    assert len(ops) == 3 and all('project_kernel' in n for n in ops), ops
