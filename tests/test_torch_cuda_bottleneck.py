"""The bottleneck-chain CUDA kernel against its plain PyTorch version, on
a card.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_bottleneck.py -m cuda --noconftest

Shapes: every ResNet-50 stage's identity block on 512x672 frames (the
pipeline's stage-1 bucket), at batch 2, plus odd H and W; chains of 1-3
blocks; float32 and bfloat16. The bf16 kernel runs on the tensor cores
in m16n8k16 tiles, so further cases put its edges to work: pixel counts
per tile that are not a multiple of 16, M = 16 (one k16 step), C = 16
and 48 (a K chunk of 32 cut short), every candidate output tile forced
at small shapes and the ones that fit at layer4 (C = 2048, M = 512) at
batch 16, and two launches that must agree bit for bit (no atomics, a
fixed order of sums). Budgets, relative to max(1, max |plain|):
fp32 1e-4 (both sides exact fp32, only the summation order differs);
bf16 2^-6, about two bf16 steps at the largest value (a sum that lands
near a rounding boundary of h1, h2 or y may round the other way and
carry into the next block).
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch.ops import bottleneck as TB

STAGES = [(128, 168, 256, 64), (64, 84, 512, 128), (32, 42, 1024, 256),
          (16, 21, 2048, 512)]
ODD = [(13, 11, 256, 64), (7, 9, 64, 16), (5, 3, 32, 16), (4, 5, 16, 16),
       (9, 14, 48, 32)]
# (B, H, W, C, M, (TH, TW)): forced bf16 output tiles; the layer4 tiles
# are the ones whose shared memory fits at M = 512.
FORCED_TILES = ([(2, 13, 11, 48, 16, t) for t in (
    (8, 16), (16, 8), (8, 8), (8, 7), (7, 8), (8, 6), (6, 8), (4, 8),
    (8, 4), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))] +
    [(16, 16, 21, 2048, 512, t) for t in ((8, 8), (8, 7), (8, 6), (4, 8))] +
    [(2, 13, 11, 256, 128, t) for t in ((8, 6), (1, 1))])
BUDGET = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


def random_chain(B, H, W, C, M, k, seed, dtype, device):
    """Post-ReLU x and k blocks of He-scaled folded weights (fp32, cast
    by the wrapper), so activations stay O(1) through the chain."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype('f4')).to(device)

    x = torch.relu(t(B, H, W, C, scale=1.0)).to(dtype)
    ws = tuple((t(C, M, scale=(2 / C) ** 0.5), t(M, scale=0.1),
                t(9, M, M, scale=(2 / (9 * M)) ** 0.5), t(M, scale=0.1),
                t(M, C, scale=(0.5 / M) ** 0.5), t(C, scale=0.1))
               for _ in range(k))
    return x, ws


def _check(x, ws, tile=None):
    before = TB.LAUNCHES
    if tile is None:
        out = TB.fused_bottleneck_chain(x, ws)
    else:
        out = TB._launch(x, ws[0], tile)
    torch.cuda.synchronize()
    assert TB.LAUNCHES == before + len(ws)
    ref = TB.fused_bottleneck_chain_plain(x, ws)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert out.is_contiguous()
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    assert err <= BUDGET[x.dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k', [1, 2, 3])
@pytest.mark.parametrize('shape', STAGES + ODD)
def test_kernel_matches_plain(cuda_device, shape, k, dtype):
    H, W, C, M = shape
    _check(*random_chain(2, H, W, C, M, k, seed=H * k, dtype=dtype,
                         device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize('case', FORCED_TILES)
def test_bf16_forced_tile_matches_plain(cuda_device, case):
    B, H, W, C, M, tile = case
    _check(*random_chain(B, H, W, C, M, 1, seed=7, dtype=torch.bfloat16,
                         device=cuda_device), tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [STAGES[0], STAGES[3], ODD[0]])
def test_bf16_repeat_launches_agree_bit_for_bit(cuda_device, shape):
    H, W, C, M = shape
    x, ws = random_chain(2, H, W, C, M, 2, seed=3, dtype=torch.bfloat16,
                         device=cuda_device)
    first = TB.fused_bottleneck_chain(x, ws)
    second = TB.fused_bottleneck_chain(x, ws)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_identity_bottleneck_is_a_chain_of_one(cuda_device):
    x, ws = random_chain(1, 9, 10, 128, 32, 1, 0, torch.float32,
                         cuda_device)
    torch.testing.assert_close(TB.fused_identity_bottleneck(x, *ws[0]),
                               TB.fused_bottleneck_chain(x, ws), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['channels', 'device', 'layout', 'k_ge_h'])
def test_refused_operands_raise_before_launch(cuda_device, case):
    x, ws = random_chain(1, 6, 5, 64, 16, 2, 0, torch.float32, cuda_device)
    if case == 'channels':          # C not a multiple of 16
        x, ws = random_chain(1, 6, 5, 40, 16, 1, 0, torch.float32,
                             cuda_device)
    elif case == 'device':
        ws = ((ws[0][0].cpu(),) + ws[0][1:],) + ws[1:]
    elif case == 'layout':
        x = x.permute(0, 2, 1, 3)
    elif case == 'k_ge_h':
        x = x[:, :2].contiguous()
    before = TB.LAUNCHES
    with pytest.raises(ValueError):
        TB.fused_bottleneck_chain(x, ws)
    assert TB.LAUNCHES == before
