"""spec_tpu_torch FusedResNet vs spec_tpu fused_resnet_apply and vs the
port's own unfused ResNet, on the CPU (identity chains through the
kernel wrapper's plain version). ResNet-50 variables come from the JAX
module with randomized BN statistics and reach the port through
``state_dict_from_flax``. The means are centred (N(0, 0.1), variances in
[0.75, 1.25)): tests/test_fused_resnet.py draws means in [0.5, 1), which
drives every activation of the trunk to 0, so its comparison holds only
zeros; the tests here check that the map is not trivial."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.models import backbones as JBack
from spec_tpu.models.backbones.fused_resnet import fused_resnet_apply
from spec_tpu_torch.models.backbones.fused_resnet import FusedResNet
from spec_tpu_torch.models.backbones.resnet import get_backbone
from spec_tpu_torch.ops import bottleneck as TB
from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

SHAPE = (2, 64, 96, 3)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize_bn_stats(rng, variables):
    """Centred running means N(0, 0.1), variances in [0.75, 1.25)."""
    def draw(path, a):
        if path[-1].key == 'mean':
            return jnp.asarray(rng.randn(*a.shape).astype('f4') * 0.1)
        return jnp.asarray(rng.rand(*a.shape).astype('f4') * 0.5 + 0.75)

    return {'params': variables['params'],
            'batch_stats': jax.tree_util.tree_map_with_path(
                draw, variables['batch_stats'])}


@pytest.fixture(scope='module')
def resnet50():
    rng = np.random.RandomState(7)
    model = JBack.get_backbone('resnet50')
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + SHAPE[1:]))
    variables = randomize_bn_stats(rng, variables)
    port = get_backbone('resnet50')
    port.load_state_dict(state_dict_from_flax(variables, 'resnet',
                                              'resnet50'))
    x = rng.randn(*SHAPE).astype('f4')
    return variables, port.eval(), x


def test_fused_trunk_matches_jax_fused_resnet(resnet50):
    """fp32: atol 5e-4, rtol 1e-4 (tests/test_fused_resnet.py); the
    identity blocks go through fused_bottleneck_chain (12 blocks in 4
    chains, no kernel launch on the CPU)."""
    variables, port, x = resnet50
    ref = fused_resnet_apply(variables, jnp.asarray(x), arch='resnet50',
                             compute_dtype=jnp.float32, interpret=True)
    fused = FusedResNet(port, dtype=torch.float32)
    before = TB.LAUNCHES
    with torch.no_grad():
        out = fused(torch.from_numpy(x))
    assert TB.LAUNCHES == before
    assert tuple(out.shape) == ref.shape == (2, 2, 3, 2048)
    assert out.dtype == torch.float32
    assert (np.asarray(ref) > 0).mean() > 0.3     # a live feature map
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=1e-4)


def test_bf16_fused_trunk_matches_jax_fused_resnet(resnet50):
    """bf16 against the JAX trunk in bf16. Both round at every layer but
    not at the same points (the JAX identity blocks take XLA's path,
    which rounds each conv before its bias; the port rounds where the
    Pallas kernel does), so the budget is a bf16 one: relative L2 error
    2e-2 (measured 9.3e-3; each trunk is 8.1e-3 / 8.6e-3 from the fp32
    JAX trunk) and max abs 2^-5 x max |ref|, four bf16 steps at the
    largest value (measured 0.125 at max |ref| 10.19)."""
    variables, port, x = resnet50
    ref = np.asarray(fused_resnet_apply(
        variables, jnp.asarray(x), arch='resnet50',
        compute_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32))
    with torch.no_grad():
        out = FusedResNet(port, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    out = out.float().numpy()
    assert (ref > 0).mean() > 0.3
    assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)
    assert np.abs(out - ref).max() <= 2.0 ** -5 * np.abs(ref).max()


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_conv_identity_trunk_matches_jax_fused_resnet(resnet50, dtype):
    """``k3=False`` (the predictor's trunk: identity blocks as folded
    convolutions, as the JAX trunk runs them under its all-zero policy)
    against the JAX trunk, within the budgets of the two tests above;
    no chain call."""
    variables, port, x = resnet50
    jdt, tdt = {'fp32': (jnp.float32, torch.float32),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = np.asarray(fused_resnet_apply(
        variables, jnp.asarray(x), arch='resnet50', compute_dtype=jdt,
        interpret=True).astype(jnp.float32))
    fused = FusedResNet(port, dtype=tdt, k3=False)
    assert not any('_w1' in k for k in fused.state_dict())
    with torch.no_grad():
        out = fused(torch.from_numpy(x))
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    out = out.float().numpy()
    assert (ref > 0).mean() > 0.3
    if dtype == 'fp32':
        np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-4)
    else:
        assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)
        assert np.abs(out - ref).max() <= 2.0 ** -5 * np.abs(ref).max()


def test_fused_trunk_matches_unfused_resnet(resnet50):
    """Folding BN changes only the rounding: same budget as above."""
    _, port, x = resnet50
    with torch.no_grad():
        out = FusedResNet(port, dtype=torch.float32)(torch.from_numpy(x))
        ref = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.numpy(),
                               ref.permute(0, 2, 3, 1).numpy(), atol=5e-4,
                               rtol=1e-4)


def test_fused_trunk_is_a_snapshot(resnet50):
    """The folded buffers do not follow later changes of the source
    until refresh() (test_refresh_follows_the_source)."""
    _, port, x = resnet50
    fused = FusedResNet(port, dtype=torch.float32)
    with torch.no_grad():
        before = fused(torch.from_numpy(x[:1]))
        saved = port.layer1[1].bn2.running_mean.clone()
        port.layer1[1].bn2.running_mean.add_(1.0)
        try:
            after = fused(torch.from_numpy(x[:1]))
        finally:
            port.layer1[1].bn2.running_mean.copy_(saved)
    torch.testing.assert_close(before, after, rtol=0, atol=0)


def test_refresh_follows_the_source(resnet50):
    """refresh() folds a changed source again, into the same storage, and
    does nothing while the source is unchanged."""
    _, port, x = resnet50
    fused = FusedResNet(port, dtype=torch.float32)
    assert not fused.refresh()
    ptrs = {k: v.data_ptr() for k, v in fused.state_dict().items()}
    bn = port.layer3[2].bn2
    saved = bn.running_mean.clone(), bn.weight.detach().clone()
    try:
        with torch.no_grad():
            bn.running_mean.add_(0.5)
            bn.weight.mul_(1.5)
            assert fused.refresh() and not fused.refresh()
            out = fused(torch.from_numpy(x[:1]))
            ref = port(torch.from_numpy(x[:1]).permute(0, 3, 1, 2))
    finally:
        with torch.no_grad():
            bn.running_mean.copy_(saved[0])
            bn.weight.copy_(saved[1])
    assert {k: v.data_ptr() for k, v in fused.state_dict().items()} == ptrs
    np.testing.assert_allclose(out.numpy(),
                               ref.permute(0, 2, 3, 1).numpy(), atol=5e-4,
                               rtol=1e-4)


def test_refresh_refuses_an_inference_mode_source():
    """A trunk made under inference mode keeps no version counters: the
    fold is a snapshot and refresh() says so instead of never folding."""
    with torch.inference_mode():
        port = get_backbone('resnet50').eval()
    fused = FusedResNet(port, dtype=torch.float32, k3=False)
    with pytest.raises(RuntimeError, match='inference_mode'):
        fused.refresh()


@pytest.mark.parametrize('arch', ['resnet18', 'resnet34'])
def test_fused_trunk_rejects_basicblock_archs(arch):
    with pytest.raises(ValueError, match='Bottleneck'):
        FusedResNet(get_backbone(arch))
    with pytest.raises(ValueError):
        fused_resnet_apply({}, jnp.zeros((1, 32, 32, 3)), arch=arch)
