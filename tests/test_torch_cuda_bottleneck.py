"""The bottleneck-chain CUDA kernel against its plain PyTorch version, on
a card.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_bottleneck.py -m cuda --noconftest

Shapes: every ResNet-50 stage's identity block on 512x672 frames (the
pipeline's stage-1 bucket), at batch 2, plus odd H and W; chains of 1-3
blocks; float32 and bfloat16; and layer1 at the bench's batch of 128. The kernel runs on the tensor cores, bf16
in m16n8k16 tiles and fp32 as 3xTF32 in m16n8k8 tiles, so further cases
put its edges to work in both types: pixel counts per tile that are not
a multiple of 16, M = 16 (one k16 step), C = 16 and 48 (a bf16 K chunk
of 32 cut short), every candidate output tile forced at small shapes and
the ones that fit at layer4 (C = 2048, M = 512) at batch 16, and two
launches that must agree bit for bit (no atomics, a fixed order of
sums). Budgets, relative to max(1, max |plain|): fp32 1e-4 (3xTF32 keeps
each product within about 2^-21 of fp32's, and the order of the sums
differs); bf16 2^-6, about two bf16 steps at the largest value (a sum
that lands near a rounding boundary of h1, h2 or y may round the other
way and carry into the next block). And fp32 against the chain in
float64, within ``F64_BUDGET``: a bound that 3xTF32 meets and a single
TF32 pass does not (sized by tests/test_torch_bottleneck.py's emulation
of both).
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch.ops import bottleneck as TB

STAGES = [(128, 168, 256, 64), (64, 84, 512, 128), (32, 42, 1024, 256),
          (16, 21, 2048, 512)]
ODD = [(13, 11, 256, 64), (7, 9, 64, 16), (5, 3, 32, 16), (4, 5, 16, 16),
       (9, 14, 48, 32)]
DTYPES = (torch.float32, torch.bfloat16)
# (dtype, B, H, W, C, M, (TH, TW)): forced output tiles, (0, 0) the one
# the kernel picks; the layer4 tiles are the ones whose shared memory
# fits at M = 512 (fp32's h1 and h2 are twice bf16's).
LAYER4_TILES = {torch.bfloat16: ((8, 8), (8, 7), (8, 6), (4, 8), (0, 0)),
                torch.float32: ((4, 8), (8, 4), (4, 4), (2, 4), (0, 0))}
FORCED_TILES = ([(dt, 2, 13, 11, 48, 16, t) for dt in DTYPES for t in (
    (8, 16), (16, 8), (8, 8), (8, 7), (7, 8), (8, 6), (6, 8), (4, 8),
    (8, 4), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))] +
    [(dt, 16, 16, 21, 2048, 512, t) for dt in DTYPES
     for t in LAYER4_TILES[dt]] +
    [(dt, 2, 13, 11, 256, 128, t) for dt in DTYPES
     for t in ((8, 6), (1, 1))])
BUDGET = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# fp32 against float64, relative to max(1, max |float64|): emulated on
# one layer4 bottleneck, 3xTF32 errs by ~2.3e-7 (as exact fp32 does) and
# one TF32 pass by ~2.2e-4; the budget keeps a margin over 4x from both.
F64_BUDGET = 1e-5


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
def test_forced_tile_matches_plain(cuda_device, case):
    dtype, B, H, W, C, M, tile = case
    _check(*random_chain(B, H, W, C, M, 1, seed=7, dtype=dtype,
                         device=cuda_device), tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [STAGES[0], STAGES[3], ODD[0]])
def test_repeat_launches_agree_bit_for_bit(cuda_device, shape, dtype):
    H, W, C, M = shape
    x, ws = random_chain(2, H, W, C, M, 2, seed=3, dtype=dtype,
                         device=cuda_device)
    first = TB.fused_bottleneck_chain(x, ws)
    second = TB.fused_bottleneck_chain(x, ws)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_layer1_at_the_bench_batch_matches_plain(cuda_device, dtype):
    """B = 128 frames of 512x672 at layer1: x holds 704,643,072 elements
    (2.8 GB in fp32), past 2^31 bytes, as in the bench pipeline. x is
    drawn on the card (a host draw of that size takes seconds)."""
    H, W, C, M = STAGES[0]
    _, ws = random_chain(1, 4, 4, C, M, 1, seed=9, dtype=dtype,
                         device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.relu(torch.randn(128, H, W, C, generator=g,
                               device=cuda_device)).to(dtype)
    _check(x, ws)


def chain_float64(x, ws):
    """The chain in float64, rounding nowhere."""
    y = x.double()
    for w1, b1, w2, b2, w3, b3 in ws:
        M = w1.shape[-1]
        w1, b1, w2, b2, w3, b3 = (t.double() for t in (w1, b1, w2, b2, w3,
                                                       b3))
        h1 = torch.relu(y @ w1 + b1)
        k2 = w2.reshape(3, 3, M, M).permute(3, 2, 0, 1)
        h2 = torch.nn.functional.conv2d(h1.permute(0, 3, 1, 2), k2,
                                        padding=1)
        h2 = torch.relu(h2.permute(0, 2, 3, 1) + b2)
        y = torch.relu(h2 @ w3 + b3 + y)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [STAGES[2], STAGES[3]])
def test_fp32_matches_float64_closer_than_one_tf32_pass(cuda_device,
                                                         shape):
    H, W, C, M = shape
    x, ws = random_chain(2, H, W, C, M, 1, seed=5, dtype=torch.float32,
                         device=cuda_device)
    out = TB.fused_bottleneck_chain(x, ws)
    ref = chain_float64(x, ws)
    err = (out.double() - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    assert err <= F64_BUDGET * scale, (err, scale)


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
