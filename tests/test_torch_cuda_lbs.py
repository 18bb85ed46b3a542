"""The fused LBS CUDA kernel against its plain PyTorch version, on a card.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_lbs.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.core.geometry import rodrigues
from spec_tpu_torch.ops import lbs as L

BUDGET = 1e-5   # m: exact fp32 on both sides, only the summation order differs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


def _operands(V, B, seed, device):
    assets = S.create_test_assets(num_vertices=V).to(device)
    packed = L.pack_lbs_operands(assets).to(device)
    rng = np.random.RandomState(seed)
    betas = torch.from_numpy(rng.randn(B, 10).astype('f4') * 0.5).to(device)
    rot = rodrigues(torch.from_numpy(
        rng.randn(B, 24, 3).astype('f4') * 0.4).to(device))
    joints_rest = packed.joints_template[None] + (
        betas @ packed.shapedirs_j).reshape(B, 24, 3)
    world = S._rigid_transform_chain(rot, joints_rest, assets.parents)
    rel_tf = S._rest_corrected(world, joints_rest)[..., :3, :].contiguous()
    return packed, L.lbs_coeffs(betas, rot), rel_tf


# Batches on both sides of every pass width (the kernel walks the batch
# in passes of up to 16 rows over one staged vertex tile), up to the
# bench pipeline's and the eval step's B = 128 and compute_error's chunk
# of B = 256; V = 20 is under the 32-vertex tile, 333 and 1000 end in a
# partial tile.
@pytest.mark.cuda
@pytest.mark.parametrize('B,V', [
    (1, 6890), (2, 6890), (3, 6890), (8, 6890), (16, 6890), (31, 6890),
    (32, 6890), (33, 6890), (40, 6890), (64, 6890), (128, 6890),
    (256, 6890), (5, 333), (1, 20), (17, 20), (6, 1000)])
def test_kernel_matches_plain(cuda_device, B, V):
    packed, coeffs, rel_tf = _operands(V, B, seed=B, device=cuda_device)
    before = L.LAUNCHES
    out = L.fused_lbs_vertices(packed, coeffs, rel_tf)
    torch.cuda.synchronize()
    assert L.LAUNCHES == before + 1
    ref = L.fused_lbs_vertices_plain(packed, coeffs, rel_tf)
    assert out.shape == (B, V, 3)
    assert (out - ref).abs().max().item() <= BUDGET


@pytest.mark.cuda
def test_smpl_forward_fused_on_card_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    betas = rng.randn(4, 10).astype('f4')
    body = rng.randn(4, 23, 3).astype('f4') * 0.3
    glob = rng.randn(4, 1, 3).astype('f4') * 0.3
    cpu = S.smpl_forward(S.create_test_assets(), torch.from_numpy(betas),
                         torch.from_numpy(body), torch.from_numpy(glob),
                         joint_set='spin49')
    gpu_assets = S.with_packed_lbs(S.create_test_assets().to(cuda_device))
    before = L.LAUNCHES
    gpu = S.smpl_forward(gpu_assets, *(torch.from_numpy(a).to(cuda_device)
                                       for a in (betas, body, glob)),
                         joint_set='spin49')
    assert L.LAUNCHES == before + 1
    np.testing.assert_allclose(gpu.vertices.cpu().numpy(),
                               cpu.vertices.numpy(), atol=BUDGET)
    np.testing.assert_allclose(gpu.joints.cpu().numpy(), cpu.joints.numpy(),
                               atol=BUDGET)


@pytest.mark.cuda
def test_mixed_devices_raise_before_launch(cuda_device):
    packed, coeffs, rel_tf = _operands(100, 2, seed=0, device=cuda_device)
    before = L.LAUNCHES
    with pytest.raises(ValueError, match='is on'):
        L.fused_lbs_vertices(packed, coeffs, rel_tf.cpu())
    assert L.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 8, 33])
def test_repeat_launches_agree_bit_for_bit(cuda_device, B):
    """No atomics: the partial sums meet in a fixed order."""
    packed, coeffs, rel_tf = _operands(6890, B, seed=7, device=cuda_device)
    first = L.fused_lbs_vertices(packed, coeffs, rel_tf)
    second = L.fused_lbs_vertices(packed, coeffs, rel_tf)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_one_launch_per_call_at_b64(cuda_device):
    packed, coeffs, rel_tf = _operands(6890, 64, seed=1, device=cuda_device)
    before = L.LAUNCHES
    for k in range(1, 4):
        L.fused_lbs_vertices(packed, coeffs, rel_tf)
        assert L.LAUNCHES == before + k
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_refused_launch_raises(cuda_device):
    """dirs 4 bytes off a 16-byte boundary: the wrapper names it before any
    launch, and the kernel's C entry, called past the wrapper's checks,
    refuses it with a CUDA error; neither counts a launch."""
    packed, coeffs, rel_tf = _operands(100, 2, seed=0, device=cuda_device)
    flat = torch.empty(packed.dirs.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(packed.dirs.shape)
    shifted.copy_(packed.dirs)
    bad = dataclasses.replace(packed, dirs=shifted)
    before = L.LAUNCHES
    with pytest.raises(ValueError, match='dirs must start on a 16-byte'):
        L.fused_lbs_vertices(bad, coeffs, rel_tf)
    with pytest.raises(RuntimeError, match='CUDA error'):
        L._launch(shifted, packed.weights_t, coeffs, rel_tf,
                  packed.num_vertices)
    assert L.LAUNCHES == before


def _grads(packed, coeffs, rel_tf, grad, fn):
    """Cotangents of dirs, weights_t, coeffs and rel_tf through ``fn``."""
    leaves = [packed.dirs.clone().requires_grad_(True),
              packed.weights_t.clone().requires_grad_(True),
              coeffs.clone().requires_grad_(True),
              rel_tf.clone().requires_grad_(True)]
    out = fn(dataclasses.replace(packed, dirs=leaves[0], weights_t=leaves[1]),
             leaves[2], leaves[3])
    return torch.autograd.grad(out, leaves, grad)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 8, 32])
def test_kernel_gradient_matches_plain(cuda_device, B):
    """Autograd through the kernel (its forward plus the closed-form
    backward) against autograd through the plain version: all four
    cotangents within 1e-4 of the largest entry (TPU_CHECKS_r05.json's
    relative budget); one launch, none in the backward."""
    packed, coeffs, rel_tf = _operands(6890, B, seed=B, device=cuda_device)
    grad = torch.from_numpy(np.random.RandomState(B).randn(
        B, 6890, 3).astype('f4')).to(cuda_device)
    before = L.LAUNCHES
    got = _grads(packed, coeffs, rel_tf, grad, L.fused_lbs_vertices)
    assert L.LAUNCHES == before + 1
    want = _grads(packed, coeffs, rel_tf, grad, L.fused_lbs_vertices_plain)
    for name, g, w in zip(('dirs', 'weights_t', 'coeffs', 'rel_tf'), got,
                          want):
        assert g.shape == w.shape, name
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err)
    assert not got[0][..., 6890:].any() and not got[1][:, 6890:].any()
