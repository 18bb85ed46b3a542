"""spec_tpu_torch.ops.bottleneck vs spec_tpu.ops.pallas.bottleneck on the
CPU: fold_bn, and the chain's plain version against the Pallas kernel in
interpret mode on the same numpy inputs (the JAX tests' cases and
tolerances, tests/test_fused_resnet.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spec_tpu.ops.pallas import bottleneck as JB
from spec_tpu_torch.ops import bottleneck as TB
from test_torch_cuda_bottleneck import (F64_BUDGET, STAGES, chain_float64,
                                        random_chain)


def _block_weights(rng, C, M):
    return (rng.randn(C, M).astype('f4') * 0.05,
            rng.randn(M).astype('f4') * 0.1,
            rng.randn(9, M, M).astype('f4') * 0.05,
            rng.randn(M).astype('f4') * 0.1,
            rng.randn(M, C).astype('f4') * 0.05,
            rng.randn(C).astype('f4') * 0.1)


def _chain(rng, k, H, W, C=256, M=64, B=2):
    x = rng.randn(B, H, W, C).astype('f4') * 0.5
    ws = [_block_weights(rng, C, M) for _ in range(k)]
    return x, ws


def _torch(ws):
    return tuple(tuple(torch.from_numpy(a) for a in w) for w in ws)


def _jax(ws):
    return tuple(tuple(jnp.asarray(a) for a in w) for w in ws)


def test_fold_bn_matches_jax(rng):
    k_hwio = rng.randn(3, 3, 8, 16).astype('f4')
    scale = rng.rand(16).astype('f4') + 0.5
    bias = rng.randn(16).astype('f4')
    mean = rng.randn(16).astype('f4')
    var = rng.rand(16).astype('f4') + 0.1
    kj, bj = JB.fold_bn(*(jnp.asarray(a) for a in (k_hwio, scale, bias,
                                                   mean, var)))
    kt, bt = TB.fold_bn(torch.from_numpy(k_hwio.transpose(3, 2, 0, 1)),
                        *(torch.from_numpy(a) for a in (scale, bias, mean,
                                                        var)))
    assert kt.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(kt.numpy().transpose(2, 3, 1, 0),
                               np.asarray(kj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6,
                               atol=1e-6)
    # 1x1 convs in (O, I) form fold along dim 0 as well.
    k2, _ = TB.fold_bn(torch.from_numpy(k_hwio[0, 0].T.copy()),
                       *(torch.from_numpy(a) for a in (scale, bias, mean,
                                                       var)))
    np.testing.assert_allclose(k2.numpy().T, np.asarray(kj)[0, 0],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('k,rt,hw', [(1, 16, (16, 24)), (2, 16, (16, 24)),
                                     (3, 8, (24, 11)), (2, 8, (13, 24))])
def test_plain_chain_matches_pallas_interpret(rng, k, rt, hw):
    """fp32: atol 5e-4, rtol 1e-4 (tests/test_fused_resnet.py), incl. odd
    H / W and the border zeroing of h1 in every block of the chain."""
    x, ws = _chain(rng, k, *hw)
    ref = JB.fused_bottleneck_chain(jnp.asarray(x), _jax(ws),
                                    interpret=True, row_tile=rt)
    out = TB.fused_bottleneck_chain_plain(torch.from_numpy(x), _torch(ws))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=1e-4)


def test_plain_chain_bf16_matches_pallas_interpret(rng):
    """bf16 activations and weights, fp32 sums, rounded at h1, h2 and y
    on both sides. The summation orders differ, so a value near a
    rounding boundary can land one bf16 step apart and carry into the
    next block: measured max |diff| 0.0039 at |y| <= 2.3 over two blocks,
    99.83 % of the values equal. Budget: 0.0156 (one bf16 step in
    [2, 4)) and at least 99 % equal."""
    x, ws = _chain(rng, 2, 12, 10)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = JB.fused_bottleneck_chain(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), _jax(ws),
        interpret=True, row_tile=4)
    out = TB.fused_bottleneck_chain_plain(xb, _torch(ws))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - ref)
    assert diff.max() <= 0.0156
    assert (diff == 0).mean() >= 0.99


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch(rng):
    x, ws = _chain(rng, 2, 9, 7, C=32, M=16)
    xt, wt = torch.from_numpy(x), _torch(ws)
    before = TB.LAUNCHES
    out = TB.fused_bottleneck_chain(xt, wt)
    one = TB.fused_identity_bottleneck(xt, *wt[0])
    assert TB.LAUNCHES == before
    torch.testing.assert_close(out, TB.fused_bottleneck_chain_plain(xt, wt),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        one, TB.fused_bottleneck_chain_plain(xt, wt[:1]), rtol=0, atol=0)


def _bad(case, x, ws):
    w = list(ws[0])
    if case == 'k_ge_h':
        return x[:, :2].contiguous(), ws
    if case == 'empty':
        return x, ()
    if case == 'x_dtype':
        return x.double(), ws
    if case == 'x_rank':
        return x[0], ws
    if case == 'x_layout':
        return x.transpose(1, 2), ws
    if case == 'w_shape':
        w[2] = w[2][:8]
    elif case == 'w_layout':
        w[0] = w[0].t().contiguous().t()
    elif case == 'w_dtype':
        w[4] = w[4].to(torch.int32)
    elif case == 'w_device':
        w[1] = w[1].to('meta')
    elif case == 'x_device':
        return x.to('meta'), tuple(tuple(t.to('meta') for t in b)
                                   for b in ws)
    return x, (tuple(w),) + tuple(ws[1:])


@pytest.mark.parametrize('case,err', [
    ('k_ge_h', ValueError), ('empty', ValueError), ('x_dtype', TypeError),
    ('x_rank', ValueError), ('x_layout', ValueError),
    ('w_shape', ValueError), ('w_layout', ValueError),
    ('w_dtype', TypeError), ('w_device', ValueError),
    ('x_device', ValueError)])
def test_wrapper_refuses_bad_operands(rng, case, err):
    x, ws = _chain(rng, 2, 6, 5, C=32, M=16, B=1)
    x, ws = _bad(case, torch.from_numpy(x), _torch(ws))
    before = TB.LAUNCHES
    with pytest.raises(err):
        TB.fused_bottleneck_chain(x, ws)
    assert TB.LAUNCHES == before


def test_k_ge_h_raises_like_jax(rng):
    x, ws = _chain(rng, 3, 3, 5, C=32, M=16, B=1)
    with pytest.raises(ValueError, match='height'):
        JB.fused_bottleneck_chain(jnp.asarray(x), _jax(ws), interpret=True)
    with pytest.raises(ValueError, match='height'):
        TB.fused_bottleneck_chain(torch.from_numpy(x), _torch(ws))


def _tf32(t):
    """fp32 rounded to TF32, to nearest with ties away from zero (as
    cvt.rna.tf32.f32), on the bit pattern: the 13 low mantissa bits go."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(t):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _tf32_matmul(a, b, passes):
    """a @ b from TF32 parts with fp32 sums: 3 passes (a_lo b_hi + a_hi
    b_lo + a_hi b_hi, as the kernel's 3xTF32) or 1 (a_hi b_hi). Products
    of TF32 values are exact in fp32, so one fp32 product over the
    stacked parts takes the three with fp32 sums."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if passes == 1:
        return ah @ bh
    return torch.cat([al, ah, ah], 1) @ torch.cat([bh, bl, bh], 0)


def _bottleneck_tf32(x, block, passes):
    """One bottleneck with every product emulated as ``passes`` TF32
    passes; the 3x3 as one product over the 9 taps' h1 (k = tap M + m)."""
    w1, b1, w2, b2, w3, b3 = block
    B, H, W, C = x.shape
    M = w1.shape[1]
    h1 = torch.relu(_tf32_matmul(x.reshape(-1, C), w1, passes) + b1)
    h1 = F.pad(h1.reshape(B, H, W, M), (0, 0, 1, 1, 1, 1))
    taps = torch.cat([h1[:, dy:dy + H, dx:dx + W] for dy in range(3)
                      for dx in range(3)], -1).reshape(-1, 9 * M)
    h2 = torch.relu(_tf32_matmul(taps, w2.reshape(9 * M, M), passes) + b2)
    y = _tf32_matmul(h2, w3, passes) + b3 + x.reshape(-1, C)
    return torch.relu(y).reshape(B, H, W, C)


@pytest.mark.parametrize('stage', [2, 3])
def test_3xtf32_is_within_the_float64_budget_and_one_pass_is_not(stage):
    """The card test's float64 budget (F64_BUDGET) sized on the CPU: one
    bottleneck at layer3's or layer4's widths (the 3x3 is 9 M deep) on
    the card test's operands, every product emulated from TF32 parts.
    3xTF32 stays 4x under the budget, one TF32 pass 4x over it."""
    _, _, C, M = STAGES[stage]
    x, ws = random_chain(1, 6, 6, C, M, 1, seed=stage, dtype=torch.float32,
                         device='cpu')
    for t in (x,) + ws[0]:
        hi, lo = _split(t)
        assert ((hi.view(torch.int32) & 0x1fff) == 0).all()
        assert ((lo.view(torch.int32) & 0x1fff) == 0).all()
        assert ((hi + lo - t).abs() <= 2.0 ** -22 * t.abs()).all()
    ref = chain_float64(x, ws)
    scale = max(1.0, ref.abs().max().item())

    def err(passes):
        out = _bottleneck_tf32(x, ws[0], passes)
        return (out.double() - ref).abs().max().item() / scale

    assert 4 * err(3) <= F64_BUDGET
    assert err(1) >= 4 * F64_BUDGET
