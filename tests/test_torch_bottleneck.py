"""spec_tpu_torch.ops.bottleneck vs spec_tpu.ops.pallas.bottleneck on the
CPU: fold_bn, and the chain's plain version against the Pallas kernel in
interpret mode on the same numpy inputs (the JAX tests' cases and
tolerances, tests/test_fused_resnet.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.ops.pallas import bottleneck as JB
from spec_tpu_torch.ops import bottleneck as TB


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
